"""Seeded traffic: the same seed gives the same content, no frame repeats
within a run, and the live schedule measures from due times."""

import numpy as np
import pytest
import tinyroot

from tvbench.content import PERIOD, Scene


def test_same_seed_same_content_and_another_seed_other_content():
    a, b = Scene(2 ** 33 + 1, 96, 64), Scene(2 ** 33 + 1, 96, 64)
    c = Scene(2 ** 33 + 2, 96, 64)
    for i in (0, 7, 1000):
        for pa, pb, pc in zip(a.planes(i), b.planes(i), c.planes(i)):
            assert np.array_equal(pa, pb)
            assert not np.array_equal(pa, pc)


def test_no_frame_repeats_within_a_run():
    """Offsets repeat only after lcm of the periods; the pictures of a
    long run (far more frames than any cell's) all differ."""
    s = Scene(5, 64, 48)
    offsets = {s.offset(i) for i in range(20000)}
    assert len(offsets) == 20000
    assert np.lcm(*PERIOD) // np.gcd(s.pan, np.lcm(*PERIOD)) > 500000
    seen = set()
    for i in range(0, 3000, 3):
        key = s.planes(i)[0].tobytes()
        assert key not in seen
        seen.add(key)


def test_the_pan_moves_the_picture_by_its_step():
    s = Scene(9, 64, 48)
    y0, y1 = s.planes(0)[0], s.planes(1)[0]
    assert np.array_equal(y0[3:, 3:], y1[:-3, :-3])


@pytest.mark.parametrize("cell", ["tx1080-films", "tx1080-clips"])
def test_the_closed_loop_runs_every_job_to_its_end(tmp_path, cell):
    root, bench = tinyroot.make(tmp_path)
    out = tinyroot.run(root, bench, cell, seconds=1.0)
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    # the window runs until the job in flight at its end is done
    assert out["info"]["window_s"] >= 1.0
    assert out["metrics"]["fps"]["value"] == pytest.approx(
        out["attempted"] * out["info"]["clip_frames"]
        / out["info"]["window_s"])


def test_the_live_schedule_counts_every_frame_due(tmp_path):
    root, bench = tinyroot.make(tmp_path)
    out = tinyroot.run(root, bench, "sfe2160-live", seconds=2.0)
    assert out["correct"], out["compared"]
    rate = out["info"]["rate_fps"]
    due = int(rate * 2.0) // 8 * 8
    assert out["attempted"] == due
    # the last frame of a GOP waits for nothing but its GOP's encode:
    # every frame's latency is at least the wait for its GOP to fill
    assert out["metrics"]["latency_p50_ms"]["value"] > 0
    assert out["metrics"]["latency_p95_ms"]["value"] >= \
        out["metrics"]["latency_p50_ms"]["value"]


class _FakeTrace:
    """Stands in for the profiler on the CPU: marks its window only."""

    def __init__(self):
        self.t0 = self.t1 = None
        self.start_s, self.events = 0.0, []

    @staticmethod
    def warm():
        pass

    def start(self):
        import time
        self.t0 = time.time()

    def stop(self):
        import time
        self.t1 = time.time()

    @property
    def open(self):
        return self.t0 is not None and self.t1 is None

    @property
    def done(self):
        return self.t1 is not None


@pytest.mark.parametrize("cell,seconds,traced", [("sfe2160-live", 0.5, True),
                                                 ("tx1080-films", 0.01, False)])
def test_a_traced_run_shorter_than_its_traced_part_still_reads(
        tmp_path, monkeypatch, cell, seconds, traced):
    """A window that holds fewer GOPs or jobs than the trace would cover
    still gives a result: the live trace covers the GOPs the window
    held; a window that ends before the traced job leaves no trace."""
    from tvbench import devtrace
    from tvbench.run import run_cell

    monkeypatch.setattr(devtrace, "DeviceTrace", _FakeTrace)
    root, bench = tinyroot.make(tmp_path)
    import time
    out = run_cell(bench, cell, 7, seconds, True, "cpu", time.time(),
                   root=root)
    assert out["correct"], out["compared"]
    assert ("breakdown" in out) is traced
