"""The reference's control-plane cases over the port's modules: the job
store and coordinator (tests/test_cluster.py), the watch-folder ingester,
its ledger and the probe (tests/test_ingest.py), and the origin
(tests/test_origin.py).

Each reference test module is read with every `thinvids_tpu` import
naming `thinvids_tpu_torch` instead, and its test classes, functions and
fixtures are collected here: every case the reference's file runs on the
JAX package runs once more on the port's modules. A case that runs a job
gets an executor on the CPU (the port's LocalExecutor defaults to the
card).
"""

import pathlib
import re
import types

import pytest
import torch

from thinvids_tpu_torch.cluster import executor as texecutor

torch.set_num_threads(1)


def reference_cases(name: str) -> types.ModuleType:
    """tests/<name>.py with its `thinvids_tpu` imports pointed at the
    port, executed as a module of its own (tracebacks keep the reference
    file's lines)."""
    path = pathlib.Path(__file__).with_name(f"{name}.py")
    src = re.sub(r"\bthinvids_tpu\b", "thinvids_tpu_torch", path.read_text())
    mod = types.ModuleType(f"{name}_over_the_port")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def collect(mod: types.ModuleType, namespace: dict) -> None:
    """Put `mod`'s test classes, test functions and fixtures into a test
    module's namespace, where pytest collects them."""
    for name, obj in vars(mod).items():
        if name.startswith(("test_", "Test")) or \
                type(obj).__name__ == "FixtureFunctionDefinition":
            namespace[name] = obj


class CpuLocalExecutor(texecutor.LocalExecutor):
    """The port's executor on the CPU, where the reference's cases build
    one with the default device."""

    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


@pytest.fixture(autouse=True)
def _executor_on_the_cpu(monkeypatch):
    monkeypatch.setattr(texecutor, "LocalExecutor", CpuLocalExecutor)


for _name in ("test_cluster", "test_ingest", "test_origin"):
    collect(reference_cases(_name), globals())
