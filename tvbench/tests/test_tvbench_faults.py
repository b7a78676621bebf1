"""`correct` comes out false for the control and for each fault a cell
can have, with the rest of a run driven as the benchmark drives it (on
the CPU at a tiny size: the harness's look for a chip is skipped).

The control is the program quantising one QP step coarser than the
configuration states; the faults are half of a batch left out, one level
altered where the device program produces it, the pictures of a GOP's
tail out of order, and a band slice left out of a picture."""

import json

import pytest
import tinyroot

CELLS = ["tx1080-films", "tx1080-clips", "sfe2160-live"]


@pytest.fixture
def tiny(tmp_path):
    return tinyroot.make(tmp_path)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(tiny, cell):
    out = tinyroot.run(*tiny, cell)
    assert out["correct"], out["compared"]
    assert all(v["value"] == 0 for v in out["compared"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_one_qp_coarser_is_not_correct(tiny, cell):
    out = tinyroot.run(*tiny, cell, program={"qp": 28})
    assert not out["correct"]
    assert out["compared"]["level_mismatches"]["value"] > 0
    assert out["compared"]["slices_off_qp"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_a_level_altered_where_it_is_produced_is_not_correct(
        tiny, cell, monkeypatch):
    from thinvids_tpu_torch.codecs.h264 import torchinter

    real = torchinter.residual_p_ref

    def altered(*args, **kw):
        out = list(real(*args, **kw))
        levels = out[0].clone()
        levels[0, 0] += 1              # one luma level of the first MB
        out[0] = levels
        return tuple(out)

    monkeypatch.setattr(torchinter, "residual_p_ref", altered)
    out = tinyroot.run(*tiny, cell)
    assert not out["correct"]
    assert out["compared"]["level_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", ["tx1080-films", "tx1080-clips"])
def test_half_of_a_wave_left_out_is_not_correct(tiny, cell, monkeypatch):
    """A wave's second half of GOPs is left out; a wave of one GOP (a
    short clip's) loses the second half of its pictures."""
    from thinvids_tpu_torch.parallel.dispatch import GopShardEncoder
    from tvbench.reference import h264

    real = GopShardEncoder.collect_wave

    def half(self, pending):
        segs = real(self, pending)
        if len(segs) > 1:
            return segs[:len(segs) // 2]
        for seg in segs:
            cut = _picture_starts(seg.payload, h264)
            seg.payload = seg.payload[:cut[len(cut) // 2]]
        return segs

    monkeypatch.setattr(GopShardEncoder, "collect_wave", half)
    out = tinyroot.run(*tiny, cell)
    assert not out["correct"]
    assert out["compared"]["frames_missing"]["value"] > 0


def test_half_of_a_gop_left_out_is_not_correct(tiny, monkeypatch):
    """The live edge hands back a GOP whose second half of pictures is
    missing."""
    from thinvids_tpu_torch.cluster import executor
    from tvbench.reference import h264

    real = executor.live_encode_batch

    def half(*args, **kw):
        bundles = real(*args, **kw)
        for b in bundles:
            for seg in b.renditions.values():
                cut = _picture_starts(seg.payload, h264)
                seg.payload = seg.payload[:cut[len(cut) // 2]]
        return bundles

    monkeypatch.setattr(executor, "live_encode_batch", half)
    out = tinyroot.run(*tiny, "sfe2160-live")
    assert not out["correct"]
    assert out["compared"]["frames_missing"]["value"] > 0


def _patch_gop_payloads(monkeypatch, cell, fn):
    """Pass every GOP's bytes, where the cell's path produces them,
    through fn(payload, h264)."""
    from thinvids_tpu_torch.cluster import executor
    from thinvids_tpu_torch.parallel.dispatch import GopShardEncoder
    from tvbench.reference import h264

    if cell == "sfe2160-live":
        real_batch = executor.live_encode_batch

        def batch(*args, **kw):
            bundles = real_batch(*args, **kw)
            for b in bundles:
                for seg in b.renditions.values():
                    seg.payload = fn(seg.payload, h264)
            return bundles

        monkeypatch.setattr(executor, "live_encode_batch", batch)
        return
    real_collect = GopShardEncoder.collect_wave

    def collect(self, pending):
        segs = real_collect(self, pending)
        for seg in segs:
            seg.payload = fn(seg.payload, h264)
        return segs

    monkeypatch.setattr(GopShardEncoder, "collect_wave", collect)


def _pictures(payload, h264):
    """(the bytes before the first picture, each picture's bytes)."""
    cut = _picture_starts(payload, h264) + [len(payload)]
    return payload[:cut[0]], [payload[a:b] for a, b in zip(cut, cut[1:])]


@pytest.mark.parametrize("cell", CELLS)
def test_the_last_two_pictures_of_each_gop_swapped_is_not_correct(
        tiny, cell, monkeypatch):
    """Pictures out of order at a GOP's tail: the reference follows every
    picture of the sampled GOPs, so the tail is held too."""
    def swap(payload, h264):
        head, pics = _pictures(payload, h264)
        return head + b"".join(pics[:-2] + pics[-1:] + pics[-2:-1])

    _patch_gop_payloads(monkeypatch, cell, swap)
    out = tinyroot.run(*tiny, cell)
    assert not out["correct"]
    assert out["compared"]["level_mismatches"]["value"] > 0


def test_a_band_slice_dropped_from_a_picture_is_not_correct(
        tiny, monkeypatch):
    """The live edge hands back every GOP with the last band slice of its
    last picture missing: that picture is not whole, whether or not its
    GOP is among those the reference follows."""
    def drop(payload, h264):
        starts, pos = [], 0
        while (i := payload.find(b"\x00\x00\x01", pos)) >= 0:
            if payload[i + 3] & 31 in (1, 5):
                starts.append(i - 1 if payload[i - 1] == 0 else i)
            pos = i + 3
        return payload[:starts[-1]]

    _patch_gop_payloads(monkeypatch, "sfe2160-live", drop)
    out = tinyroot.run(*tiny, "sfe2160-live")
    assert not out["correct"]
    assert out["compared"]["frames_missing"]["value"] > 0


def _picture_starts(stream, h264):
    """Byte offsets of the start codes that open each picture."""
    starts, pos = [], 0
    while True:
        i = stream.find(b"\x00\x00\x01", pos)
        if i < 0:
            return starts
        typ = stream[i + 3] & 31
        if typ in (1, 5) and h264.Bits(
                h264._EMULATION.sub(b"\x00\x00",
                                    stream[i + 4:i + 20])).ue() == 0:
            starts.append(i - 1 if i and stream[i - 1] == 0 else i)
        pos = i + 3


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (tinyroot.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_on_the_card_at_the_cells_size_only_the_control_fails(card, cell):
    """The cell's own configuration and mix on the card, a short window:
    a sound run is correct, the control is not."""
    import time

    from tvbench import harness
    from tvbench.run import run_cell

    bench = harness.load_benchmark()
    kw = dict(seed=2 ** 31 + 99, seconds=3.0, trace=False, device=card)
    sound = run_cell(bench, cell, t_start=time.time(), **kw)
    assert sound["correct"], sound["compared"]
    qp = int(harness.cell_spec(bench, cell)["config"]["settings"]["qp"])
    control = run_cell(bench, cell, t_start=time.time(),
                       program={"qp": qp + 1}, **kw)
    assert not control["correct"]
