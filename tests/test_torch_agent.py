"""The node agent over the port: the reference's cases
(tests/test_agent.py) on the port's `cluster.agent`, and the port's own
samplers: the cards through torch.cuda, and the host fields read from
/proc where the reference reads psutil.

The reference's test module is read with every `thinvids_tpu` import
naming `thinvids_tpu_torch` (as tests/test_torch_cluster.py does). Its
one device case asserts what JAX's CPU backend reports; the port reports
the cards, so that case is replaced by the device cases below.
"""

import builtins
import pathlib
import re
import time
import types

import pytest
import torch

from thinvids_tpu.cluster import agent as jagent
from thinvids_tpu_torch.cluster import agent as tagent

HOST_KEYS = {"cpu", "mem", "mem_used", "mem_total", "disk", "net_rx_bytes",
             "net_tx_bytes"}


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


_REF = reference_cases("test_agent")
_clean_settings = _REF._clean_settings
TestHeartbeatSinks = _REF.TestHeartbeatSinks
TestIdleGate = _REF.TestIdleGate
TestResume = _REF.TestResume


class TestSampling(_REF.TestSampling):
    #: asserts JAX's CPU backend; the port's device cases are below
    test_device_metrics_graceful = None


# ---- the port's samplers --------------------------------------------------------

class _FakeCuda:
    """torch.cuda as a host with two cards reports it."""

    @staticmethod
    def is_available():
        return True

    @staticmethod
    def device_count():
        return 2

    @staticmethod
    def get_device_name(i):
        return "NVIDIA H100 80GB HBM3"

    @staticmethod
    def mem_get_info(i):
        return (60 << 30, 80 << 30) if i == 0 else (70 << 30, 80 << 30)


def test_device_metrics_report_the_cards(monkeypatch):
    for name in ("is_available", "device_count", "get_device_name",
                 "mem_get_info"):
        monkeypatch.setattr(torch.cuda, name, getattr(_FakeCuda, name))
    m = tagent.sample_device_metrics()
    assert m == {"devices": 2, "device_kind": "NVIDIA H100 80GB HBM3",
                 "hbm_used_bytes": 30 << 30, "hbm_total_bytes": 160 << 30,
                 "hbm_pct": 18.8}
    # the keys the dashboard and the scheduler's slot count read are the
    # reference's
    assert set(m) == {"devices", "device_kind", "hbm_used_bytes",
                      "hbm_total_bytes", "hbm_pct"}


def test_device_metrics_without_a_card_and_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tagent.sample_device_metrics() == {"devices": 0,
                                              "device_kind": ""}
    # a node run on its CPU reports one device, as JAX's CPU backend does
    cpu = tagent.sample_device_metrics("cpu")
    assert cpu == {"devices": 1, "device_kind": "cpu"}
    assert jagent.sample_device_metrics()["devices"] >= 1


def test_node_agent_heartbeats_its_device():
    seen = {}
    agent = tagent.NodeAgent(lambda host, m: seen.update(m), host="n",
                             device="cpu")
    agent.tick()
    assert seen["devices"] == 1 and seen["device_kind"] == "cpu"
    assert HOST_KEYS <= set(seen)


def test_host_metrics_without_psutil_match_psutil(monkeypatch):
    psutil = pytest.importorskip("psutil")
    real_import = builtins.__import__

    def no_psutil(name, *args, **kw):
        if name == "psutil" or name.startswith("psutil."):
            raise ImportError("psutil blocked")
        return real_import(name, *args, **kw)

    vm0, io0 = psutil.virtual_memory(), psutil.net_io_counters()
    disk = psutil.disk_usage("/")
    monkeypatch.setattr(builtins, "__import__", no_psutil)
    tagent.sample_host_metrics()            # opens the cpu window
    got = tagent.sample_host_metrics()
    monkeypatch.setattr(builtins, "__import__", real_import)
    vm1, io1 = psutil.virtual_memory(), psutil.net_io_counters()
    # the reference's keys, the reference's types
    want = jagent.sample_host_metrics()
    assert set(got) == set(want) == HOST_KEYS
    assert 0.0 <= got["cpu"] <= 100.0
    assert got["mem_total"] == vm0.total
    assert min(vm0.percent, vm1.percent) - 2.0 <= got["mem"] \
        <= max(vm0.percent, vm1.percent) + 2.0
    assert min(vm0.used, vm1.used) - 0.02 * vm0.total <= got["mem_used"] \
        <= max(vm0.used, vm1.used) + 0.02 * vm0.total
    assert abs(got["disk"] - disk.percent) <= 1.0
    assert io0.bytes_recv <= got["net_rx_bytes"] <= io1.bytes_recv
    assert io0.bytes_sent <= got["net_tx_bytes"] <= io1.bytes_sent


def test_cpu_meter_reads_a_busy_window():
    meter = tagent._CpuMeter()
    assert meter.percent() == 0.0           # no window yet
    end = time.perf_counter() + 0.2
    while time.perf_counter() < end:
        pass
    assert 0.0 < meter.percent() <= 100.0
