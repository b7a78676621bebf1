"""Card checks of the host critical path's instruments (they skip without
a CUDA card; on the chip: `python -m pytest tvbench/tests/
test_tvbench_host_card.py -s`, which prints what each found).

- The clock: a kernel of known length, synchronised inside a host
  stage's span, falls inside that span on the device trace's clock, so
  the host spans name the device's idle gaps truly. The offsets from the
  span's start to the kernel's and from the kernel's end to the span's
  are printed.
- The sync count: one films wave (1080p, 4 GOPs of 32) and one 4K split-
  frame GOP (4 bands, 8 frames) under torch's sync debug mode. Every
  sync torch reports lies in one of the counted helpers (`_to_host`,
  `_wait`), and the counter counts at least as many; both counts are
  printed.
"""

import json
import time
import traceback
import warnings

import pytest

from tvbench.content import Scene

#: the helpers in which parallel/dispatch.py counts its host syncs
COUNTED = ("_to_host", "_wait")


class _Spans:
    enabled = True

    def __init__(self) -> None:
        self.spans = []

    def record(self, name, t0, dur_s, **tags) -> None:
        self.spans.append((name, t0, t0 + dur_s))


def test_device_trace_clock_matches_the_host_spans(card):
    import torch

    from thinvids_tpu_torch.parallel.dispatch import StageProfile
    from tvbench.devtrace import DeviceTrace

    DeviceTrace.warm()
    torch.cuda._sleep(1000)                 # the sleep kernel, built
    torch.cuda.synchronize()
    prof, sink = StageProfile(), _Spans()
    prof.set_tracer(sink)
    out = []
    for cycles in (20_000_000, 60_000_000):
        trace = DeviceTrace()
        trace.start()
        time.sleep(0.01)
        with prof.stage("clock_check"):
            torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
        time.sleep(0.01)
        trace.stop()
        _, s0, s1 = sink.spans[-1]
        # torch.cuda._sleep's kernel (at::cuda::sleep's spin_kernel)
        kernels = [(n, a, b) for n, a, b, _ in trace.events
                   if "spin" in n or "sleep" in n]
        assert len(kernels) == 1, trace.events
        _, k0, k1 = kernels[0]
        rec = {"cycles": cycles, "kernel_ms": 1e3 * (k1 - k0),
               "span_ms": 1e3 * (s1 - s0),
               "start_offset_ms": 1e3 * (k0 - s0),
               "end_offset_ms": 1e3 * (s1 - k1)}
        out.append(rec)
        print("clock " + json.dumps(rec), flush=True)
        # the kernel is most of the span, and inside it
        assert k1 - k0 >= 0.5 * (s1 - s0)
        assert s0 <= k0 and k1 <= s1, rec
    # the longer kernel takes about three times as long
    ratio = out[1]["kernel_ms"] / out[0]["kernel_ms"]
    assert 2.5 <= ratio <= 3.5, out


class _SyncAudit:
    """The syncs torch's sync debug mode reports, each with the stack
    that made it (a warnings.showwarning hook: it sees every thread)."""

    def __init__(self) -> None:
        self.stacks = []

    def __enter__(self):
        import torch

        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("always")
        orig = warnings.showwarning

        def hook(message, category, filename, lineno, file=None,
                 line=None):
            if "synchronizing CUDA operation" not in str(message):
                return orig(message, category, filename, lineno, file, line)
            self.stacks.append(traceback.extract_stack())

        warnings.showwarning = hook
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc) -> None:
        import torch

        torch.cuda.set_sync_debug_mode("default")
        self._ctx.__exit__(*exc)

    def sites(self) -> dict:
        """{"module:function": syncs} of the innermost frame in the
        port's package, or "outside the package"."""
        out: dict = {}
        for stack in self.stacks:
            site = "outside the package"
            for fr in reversed(stack):
                if "thinvids_tpu_torch" in fr.filename:
                    mod = fr.filename.rsplit("thinvids_tpu_torch", 1)[1]
                    site = f"{mod.strip('/').removesuffix('.py')}:{fr.name}"
                    break
            out[site] = out.get(site, 0) + 1
        return out

    def uncounted(self) -> list:
        """The stacks with no frame in a counted helper of dispatch."""
        return [s for s in self.stacks
                if not any(fr.name in COUNTED
                           and fr.filename.endswith("parallel/dispatch.py")
                           for fr in s)]


def _frames(w, h, n, seed):
    from thinvids_tpu_torch.core.types import Frame

    scene = Scene([seed, 0], w, h)
    return [Frame(*scene.planes(i)) for i in range(n)]


@pytest.mark.parametrize("shape", ["films_wave", "sfe_gop"])
def test_every_reported_sync_lies_at_a_counted_site(card, shape):
    from thinvids_tpu_torch.core.types import VideoMeta
    from thinvids_tpu_torch.parallel import dispatch

    if shape == "films_wave":
        w, h, n = 1920, 1080, 128
        enc = dispatch.GopShardEncoder(
            VideoMeta(width=w, height=h, num_frames=n), qp=27,
            gop_frames=32, device=card)
    else:
        w, h, n = 3840, 2160, 8
        enc = dispatch.SfeShardEncoder(
            VideoMeta(width=w, height=h, num_frames=n), qp=27,
            gop_frames=8, bands=4, halo_rows=32, device=card)
    frames = _frames(w, h, n, seed=20261018)
    want = enc.encode(frames)                  # builds and warms
    before = enc.stages.snapshot()["host_syncs"]
    with _SyncAudit() as audit:
        got = enc.encode(frames)
    counted = enc.stages.snapshot()["host_syncs"] - before
    assert [s.payload for s in got] == [s.payload for s in want]
    assert enc.stages.snapshot()["waves"] == 2
    rec = {"shape": shape, "frames": n, "reported": len(audit.stacks),
           "counted": counted, "reported_by_site": audit.sites()}
    print("syncs " + json.dumps(rec), flush=True)
    assert not audit.uncounted(), audit.sites()
    assert len(audit.stacks) <= counted
    # a wave: its done event, the tiny counts (4), the mv and DC prefix
    # (2) and the payload (1); an SFE frame: its done event, its tiny
    # counts (4), its dense head (1) and its payloads (1)
    assert counted == (8 if shape == "films_wave" else 7 * n)
