"""The HTTP API over the port: the reference's cases (tests/test_api.py)
on the port's `api.server`, coordinator and executor (on the CPU), and
the two places the port's server differs from the reference's:

- ``/metrics_snapshot`` reads the port's encoder totals: after a port
  encode in this process, `stage_ms` carries its waves and stages;
- without a remote board, every ``/work/*`` route answers 503, as the
  reference's does.
"""

import json
import pathlib
import re
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from thinvids_tpu_torch.api import ApiServer
from thinvids_tpu_torch.cluster import executor as texecutor
from thinvids_tpu_torch.cluster.coordinator import Coordinator
from thinvids_tpu_torch.core.types import Frame, VideoMeta
from thinvids_tpu_torch.parallel import dispatch as tdispatch

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


class CpuLocalExecutor(texecutor.LocalExecutor):
    """The port's executor on the CPU, where the reference's cases build
    one with the default device."""

    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


_REF = reference_cases("test_api")
_REF.LocalExecutor = CpuLocalExecutor
api = _REF.api
TestUi = _REF.TestUi
TestBrowsePreviewStamp = _REF.TestBrowsePreviewStamp
TestLifecycle = _REF.TestLifecycle
TestRoutes = _REF.TestRoutes

_WORK_ROUTES = [("POST", "/work/claim"), ("POST", "/work/part/s1?host=h"),
                ("POST", "/work/status"), ("POST", "/work/halo"),
                ("GET", "/work/halo?job=j&seq=0&band=0&kind=halo"),
                ("POST", "/work/chaos"), ("GET", "/work/board")]


def _request(url, method="GET", body=None, content_type="application/json"):
    req = urllib.request.Request(url, data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", content_type)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


@pytest.mark.parametrize("method,route", _WORK_ROUTES,
                         ids=[f"{m} {r.split('?')[0]}" for m, r in
                              _WORK_ROUTES])
def test_work_routes_answer_503_without_a_board(method, route):
    server = ApiServer(Coordinator()).start()
    try:
        for body, ctype in ((b"{}", "application/json"),
                            (b"\x00\x01", "application/octet-stream")):
            code, out = _request(server.url + route, method,
                                 body if method == "POST" else None, ctype)
            assert code == 503, (route, out)
            assert "no remote work backend" in out["error"]
    finally:
        server.stop()


def test_metrics_snapshot_reports_the_ports_stage_totals():
    w, h, n = 64, 48, 4
    yy, xx = np.mgrid[0:h, 0:w]
    frames = [Frame(y=((xx + yy + 9 * i) % 256).astype(np.uint8),
                    u=np.full((h // 2, w // 2), 110, np.uint8),
                    v=np.full((h // 2, w // 2), 140, np.uint8))
              for i in range(n)]
    enc = tdispatch.GopShardEncoder(VideoMeta(width=w, height=h,
                                              num_frames=n),
                                    qp=30, gop_frames=2, device="cpu")
    before = tdispatch.stage_snapshot()
    enc.encode(frames)
    server = ApiServer(Coordinator()).start()
    try:
        code, out = _request(server.url + "/metrics_snapshot")
    finally:
        server.stop()
    assert code == 200
    stage = out["stage_ms"]
    assert stage and stage.keys() == before.keys()
    # (an earlier case's executor thread may still add waves of its own)
    assert stage["waves"] - before["waves"] >= \
        enc.stages.snapshot()["waves"] > 0
    assert stage["pack"] > 0 and stage["dispatch"] > 0
    assert isinstance(out["sfe_latency_ms"], dict)
