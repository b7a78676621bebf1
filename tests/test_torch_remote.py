"""The reference's remote-backend cases over the port's modules: the
shard board, wire format, RemoteExecutor and worker daemon
(tests/test_remote.py), the durable part spool and crash-resume
(tests/test_partstore.py), the elastic farm's tenancy, capacity
controller and chaos harness (tests/test_farm.py), and the remote cases
of tests/test_obs.py (one trace over a two-worker farm job),
tests/test_abr.py (rung shards and a ladder job on the farm) and
tests/test_streaming.py (a worker decodes only its shard's range).

Each reference test module is read with every `thinvids_tpu` import
naming `thinvids_tpu_torch` instead and executed as a module of its own;
its cases are collected here and run once more on the port's modules.
The port's encoders, executors and workers take ``device="cuda"`` by
default and raise without a card, so the cases run them on the CPU: the
classes the reference's cases build are swapped for subclasses whose
default device is ``"cpu"``, and every ``cli coordinator`` / ``cli
worker`` process they spawn gets ``--device cpu`` (their `_spawn_worker`
helpers and inline Popen argument lists are rewritten for it).

One pin of test_remote.py is translated: its farm jobs plan their GOPs
with ``remote_plan_devices=8`` ("plan width pinned to the local mesh's
8 devices so both backends derive the identical GOP plan" — the
conftest's 8 virtual devices). The port's local executor encodes on one
card, whose plan is one device wide, so the pin becomes 1 there: the
farm and the single-process encode it is held against still plan the
same GOPs.
"""

import functools
import pathlib
import re
import types

import pytest
import torch

import thinvids_tpu_torch.farm as tfarm
from thinvids_tpu_torch.abr import ladder as tladder
from thinvids_tpu_torch.cluster import executor as texecutor
from thinvids_tpu_torch.cluster import remote as tremote
from thinvids_tpu_torch.core.devices import DeviceMesh
from thinvids_tpu_torch.farm import provider as tprovider
from thinvids_tpu_torch.parallel import dispatch as tdispatch
from thinvids_tpu_torch.parallel import sfefarm as tsfefarm

torch.set_num_threads(1)


def on_the_cpu(cls):
    """`cls` with ``device="cpu"`` as its default."""
    class Cpu(cls):
        def __init__(self, *args, device="cpu", **kw):
            super().__init__(*args, device=device, **kw)

    Cpu.__name__ = Cpu.__qualname__ = cls.__name__
    return Cpu


class CpuFarmBandEncoder(tsfefarm.FarmBandEncoder):
    """The port's band slice on the CPU. The reference's cases give each
    slice a one-device JAX mesh, which has no counterpart here: it is
    dropped, and the slice runs on the one CPU device. A port DeviceMesh
    is kept."""

    def __init__(self, *args, mesh=None, device="cpu", **kw):
        if not isinstance(mesh, DeviceMesh):
            mesh = None
        super().__init__(*args, device=device, mesh=mesh, **kw)


#: the port's own entry points, before any stand-in replaces them
RemoteExecutor, WorkerDaemon = tremote.RemoteExecutor, tremote.WorkerDaemon
encode_shard, FarmBandEncoder = tremote.encode_shard, tsfefarm.FarmBandEncoder

#: module attribute → its CPU stand-in, in the port's modules and in the
#: namespace of every reference module executed here
CPU_STANDINS = {
    (texecutor, "LocalExecutor"): on_the_cpu(texecutor.LocalExecutor),
    (tremote, "RemoteExecutor"): on_the_cpu(tremote.RemoteExecutor),
    (tremote, "WorkerDaemon"): on_the_cpu(tremote.WorkerDaemon),
    (tremote, "encode_shard"): functools.partial(tremote.encode_shard,
                                                 device="cpu"),
    (tprovider, "SubprocessProvider"):
        on_the_cpu(tprovider.SubprocessProvider),
    (tfarm, "SubprocessProvider"): on_the_cpu(tprovider.SubprocessProvider),
    (tladder, "LadderShardEncoder"): on_the_cpu(tladder.LadderShardEncoder),
    (tdispatch, "SfeShardEncoder"): on_the_cpu(tdispatch.SfeShardEncoder),
    (tsfefarm, "FarmBandEncoder"): CpuFarmBandEncoder,
}


def reference_cases(name: str) -> types.ModuleType:
    """tests/<name>.py with its `thinvids_tpu` imports pointed at the
    port and the daemons it spawns on the CPU, executed as a module of
    its own (tracebacks keep the reference file's lines); the names it
    imports from the port at module scope are swapped for their CPU
    stand-ins."""
    path = pathlib.Path(__file__).with_name(f"{name}.py")
    src = re.sub(r"\bthinvids_tpu\b", "thinvids_tpu_torch", path.read_text())
    src = re.sub(r'("thinvids_tpu_torch\.cli", "(?:coordinator|worker)",)',
                 r'\1 "--device", "cpu",', src)
    if name == "test_remote":
        src = src.replace("remote_plan_devices=8", "remote_plan_devices=1")
        src = src.replace('TVT_REMOTE_PLAN_DEVICES="8"',
                          'TVT_REMOTE_PLAN_DEVICES="1"')
    mod = types.ModuleType(f"{name}_over_the_port")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    for (owner, attr), standin in CPU_STANDINS.items():
        if mod.__dict__.get(attr) is getattr(owner, attr):
            mod.__dict__[attr] = standin
    return mod


def collect(mod: types.ModuleType, namespace: dict, names=None) -> None:
    """Put `mod`'s test classes, test functions and fixtures (or only
    `names`) into a test module's namespace, where pytest collects
    them."""
    for name, obj in vars(mod).items():
        if names is not None:
            if name in names:
                namespace[name] = obj
        elif name.startswith(("test_", "Test")) or \
                type(obj).__name__ == "FixtureFunctionDefinition":
            namespace[name] = obj


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    for (owner, attr), standin in CPU_STANDINS.items():
        monkeypatch.setattr(owner, attr, standin)
    # the daemons a case spawns inherit this environment: one torch
    # thread each, as this process runs, so a farm of processes does not
    # oversubscribe the host's cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


for _name in ("test_remote", "test_partstore", "test_farm"):
    collect(reference_cases(_name), globals())
collect(reference_cases("test_obs"), globals(), {"TestRemoteTrace"})
collect(reference_cases("test_abr"), globals(), {"TestRemoteLadder"})
collect(reference_cases("test_streaming"), globals(),
        {"TestRemoteShardRange"})


def test_the_farm_entry_points_refuse_a_missing_card(tmp_path,
                                                      monkeypatch):
    """RemoteExecutor, WorkerDaemon, encode_shard and FarmBandEncoder
    default to the card and raise without one: no farm path falls back
    to the CPU quietly."""
    from thinvids_tpu_torch.cluster import Coordinator
    from thinvids_tpu_torch.core.types import GopSpec, VideoMeta

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    meta = VideoMeta(width=64, height=48, num_frames=4)
    desc = tremote.Shard(
        id="j-0000", job_id="j", input_path="x.y4m", meta=meta,
        gops=(GopSpec(index=0, start_frame=0, num_frames=4),), qp=30,
        gop_frames=4, timeout_s=60.0).descriptor()
    band = dict(desc, shape="band",
                band={"start": 0, "count": 2, "total": 2, "halo_rows": 16})
    calls = [lambda: RemoteExecutor(Coordinator(), str(tmp_path / "lib"),
                                    spool_dir=str(tmp_path / "spool")),
             lambda: WorkerDaemon("http://127.0.0.1:1"),
             lambda: encode_shard(desc, []),
             lambda: encode_shard(band, []),
             lambda: FarmBandEncoder(meta, total_bands=2)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
