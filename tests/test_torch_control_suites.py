"""The reference's rate-control, executor and live suites run over the
port on an 8-entry CPU mesh: tests/test_rc.py (complexity shares, per-GOP
QP, two-pass VBR), tests/test_executor.py (a job end to end: retries,
failure attribution, the profiler, halting, progress) and the cases of
tests/test_live.py that tests/test_torch_job_suites.py does not already
run (tail ingest, the live playlist lint, the watcher, blocking reload,
a live job end to end).

Each reference module is read with every `thinvids_tpu` import naming
`thinvids_tpu_torch` (tests/test_torch_job_suites.py's
`reference_cases`). The reference's encoders and executor default to the
conftest's 8 virtual devices, and these cases count on it ("12 frames /
gop 4 wave-rounded onto the 8-device test mesh" is 8 parts; `enc8` has
8 devices). The port's ``mesh=None`` is one card (ROADMAP C, deliberate
differences), so the stand-ins run on ``DeviceMesh(("cpu",) * 8)``:
`GopShardEncoder`, `encode_clip_sharded` and `rc.encode_vbr2pass` from
tests/test_torch_parallel_suites.py, and tests/test_torch_mesh_jobs.py's
`MeshLocalExecutor` for `LocalExecutor`.

Harness pins (exact text of the reference module, replaced):

- test_rc.py (twice) and test_executor.py (once):
  ``Mesh(np.array(jax.devices()[:1]), ("gop",))`` → ``DeviceMesh(("cpu",))``;
- test_executor.py: ``default_mesh(jax.devices()[:1])`` →
  ``default_mesh(["cpu"])``.

Not collected twice: test_executor.py's
``TestEndToEnd.test_elastic_replan_on_shrunken_mesh`` and
``test_single_device_mesh_cannot_replan_fails`` run over the port in
tests/test_torch_mesh_jobs.py; test_live.py's
``test_every_settings_key_has_a_reader_outside_config`` and
``test_tail_and_packager_are_manifested_jax_free`` in
tests/test_torch_job_suites.py.
"""

import functools

import pytest
import torch

from tests.test_torch_job_suites import collect, reference_cases
from tests.test_torch_mesh_jobs import MeshLocalExecutor
from tests.test_torch_parallel_suites import MESH8, MESH_STANDINS
from thinvids_tpu_torch.cluster import executor as texecutor
from thinvids_tpu_torch.core.devices import DeviceMesh
from thinvids_tpu_torch.parallel import dispatch as tdispatch
from thinvids_tpu_torch.parallel import rc as trc

torch.set_num_threads(1)

#: module attribute → its CPU stand-in, in the port's modules and in the
#: namespace of every reference module executed here
CONTROL_STANDINS = {
    (tdispatch, "GopShardEncoder"):
        MESH_STANDINS[(tdispatch, "GopShardEncoder")],
    (tdispatch, "encode_clip_sharded"):
        MESH_STANDINS[(tdispatch, "encode_clip_sharded")],
    (trc, "encode_vbr2pass"):
        functools.partial(trc.encode_vbr2pass, device="cpu", mesh=MESH8),
    (texecutor, "LocalExecutor"): MeshLocalExecutor,
}

ONE_DEVICE = ('Mesh(np.array(jax.devices()[:1]), ("gop",))',
              'DeviceMesh(("cpu",))')


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    for (owner, attr), standin in CONTROL_STANDINS.items():
        monkeypatch.setattr(owner, attr, standin)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _cases(name, pins=()):
    mod = reference_cases(name, (), CONTROL_STANDINS, pins)
    mod.DeviceMesh = DeviceMesh
    return mod


collect(_cases("test_rc", pins=(ONE_DEVICE,)), globals())
collect(_cases("test_executor", pins=(
    ONE_DEVICE, ("default_mesh(jax.devices()[:1])",
                 'default_mesh(["cpu"])'))), globals(), leave_out={
    "TestEndToEnd.test_elastic_replan_on_shrunken_mesh",
    "TestEndToEnd.test_single_device_mesh_cannot_replan_fails"})
collect(_cases("test_live"), globals(), leave_out={
    "test_every_settings_key_has_a_reader_outside_config",
    "test_tail_and_packager_are_manifested_jax_free"})
