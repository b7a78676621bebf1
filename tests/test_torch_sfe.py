"""Port parity for split-frame encoding (SFE): the band planner, the
banded motion search, the band step cores and SfeShardEncoder, bit-exact
against the JAX package (tolerance 0: integer arithmetic end to end).

The reference puts one band on each device of a ("band",) mesh (the
conftest's 8 virtual CPU devices) and moves halo rows with
`lax.ppermute`, sums the probe and the median with `lax.psum`; the port
holds every band on one device as a leading band dimension of a stack.
The same seeded numpy inputs feed both; each reference band function
runs under `shard_map` over as many devices as there are bands.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from thinvids_tpu.codecs.h264 import jaxinter, jaxme
from thinvids_tpu.codecs.h264 import rdo as jrdo
from thinvids_tpu.codecs.h264.encoder import encode_gop as jencode_gop
from thinvids_tpu.core.devices import shard_map
from thinvids_tpu.core.types import Frame as JFrame
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu.core.types import concat_segments as jconcat
from thinvids_tpu.parallel import dispatch as jdispatch
from thinvids_tpu.parallel import planner as jplanner
from thinvids_tpu_torch.codecs.h264 import rdo as trdo
from thinvids_tpu_torch.codecs.h264 import torchinter, torchme
from thinvids_tpu_torch.core.types import Frame as TFrame
from thinvids_tpu_torch.core.types import VideoMeta as TMeta
from thinvids_tpu_torch.core.types import concat_segments as tconcat
from thinvids_tpu_torch.parallel import dispatch as tdispatch
from thinvids_tpu_torch.parallel import planner as tplanner

torch.set_num_threads(2)

RD_FEATURES = dict(mode_decision=True, pskip=True, deblock=True)


def _band_mesh(bands):
    return Mesh(np.array(jax.devices()[:bands]), ("band",))


def clip(w, h, n, step=3, seed=0, vstep=0):
    """tests/test_sfe.py's clip: a pan over a textured scene; `vstep`
    adds vertical motion (past the clamp of a thin band's halo)."""
    rng = np.random.default_rng(seed)
    pad = (abs(step) + abs(vstep)) * n + 2
    yy, xx = np.mgrid[0:h + 2 * pad, 0:w + 2 * pad]
    scene = np.clip((xx * 3 + yy * 2) % 256
                    + rng.normal(0, 2.0, yy.shape), 0, 255).astype(np.uint8)
    frames = []
    for i in range(n):
        dy, dx = pad + vstep * i, pad + step * i
        y = np.ascontiguousarray(scene[dy:dy + h, dx:dx + w])
        u = np.clip(128 + 20 * np.sin(xx[:h // 2, :w // 2] * 0.1 + i),
                    0, 255).astype(np.uint8)
        v = np.clip(128 + 20 * np.cos(yy[:h // 2, :w // 2] * 0.1 + i),
                    0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def noise_clip(w, h, n, seed=7):
    """tests/test_sfe.py's escape content: uniform noise (at qp 4 its
    levels exceed int8)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
            for _ in range(n)]


def _mixed_motion(w, h, seed=0):
    """tests/test_sfe.py's _mixed_motion: the top half moves (+9, +5),
    the bottom (-7, -3), over uniform noise."""
    rng = np.random.default_rng(seed)
    pad = 24
    scene = rng.integers(0, 255, (h + 2 * pad, w + 2 * pad)).astype(np.uint8)
    ref = scene[pad:pad + h, pad:pad + w]
    cur = np.empty_like(ref)
    cur[:h // 2] = scene[pad + 9:pad + 9 + h // 2, pad + 5:pad + 5 + w]
    cur[h // 2:] = scene[pad - 7:pad - 7 + h // 2, pad - 3:pad - 3 + w]
    ru = rng.integers(0, 255, (h // 2, w // 2)).astype(np.uint8)
    rv = rng.integers(0, 255, (h // 2, w // 2)).astype(np.uint8)
    return cur, ref, ru, rv


def _stack(a, bands):
    """numpy (H, W) → torch int16 (B, H / B, W)."""
    t = torch.from_numpy(np.asarray(a, np.int16))
    return t.reshape(bands, t.shape[0] // bands, t.shape[1])


# ---- the planner ---------------------------------------------------------------

@pytest.mark.parametrize("mbh,mbw,bands", [
    (16, 4, 8), (135, 240, 8), (135, 240, 4), (6, 4, 8), (7, 4, 4),
    (68, 120, 4), (1, 3, 5)])
def test_plan_bands_matches(mbh, mbw, bands):
    got = tplanner.plan_bands(mbh, mbw, bands)
    want = jplanner.plan_bands(mbh, mbw, bands)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert (got.num_bands, got.padded_mb_height) == \
        (want.num_bands, want.padded_mb_height)
    assert [b.end_mb_row for b in got.bands] == \
        [b.end_mb_row for b in want.bands]


@pytest.mark.parametrize("n,gop,devices", [(10, 4, 1), (16, 8, 4),
                                           (1000, 7, 2), (3, 5, 1)])
def test_plan_fixed_segments_matches(n, gop, devices):
    got = tplanner.plan_fixed_segments(n, gop, devices)
    want = jplanner.plan_fixed_segments(n, gop, devices)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_planner_validation_matches():
    for args in ((0, 4, 2), (4, 0, 2), (4, 4, 0)):
        for mod in (tplanner, jplanner):
            with pytest.raises(ValueError):
                mod.plan_bands(*args)
    for args in ((0, 4), (4, 0)):
        for mod in (tplanner, jplanner):
            with pytest.raises(ValueError):
                mod.plan_fixed_segments(*args)


# ---- the halo exchange and the banded search ------------------------------------

def test_halo_clamp_matches():
    for halo in range(0, 130):
        assert torchme.halo_clamp(halo) == jaxme.halo_clamp(halo)
    assert torchme.halo_clamp(32) == 12 and torchme.halo_clamp(16) == 8


@pytest.mark.parametrize("bands,halo", [(2, 16), (3, 8), (4, 32)])
def test_band_halo_exchange_matches(bands, halo):
    rng = np.random.default_rng(bands)
    plane = rng.integers(-300, 300, (bands * 32, 48)).astype(np.int16)
    f = shard_map(lambda p: jaxme.band_halo_exchange(p, halo, "band", bands),
                  mesh=_band_mesh(bands), in_specs=P("band"),
                  out_specs=P("band"))
    want = np.asarray(jax.jit(f)(jnp.asarray(plane))).reshape(
        bands, 32 + 2 * halo, 48)
    got = torchme.band_halo_exchange(_stack(plane, bands), halo)
    np.testing.assert_array_equal(got.numpy(), want)
    # a halo deeper than a band is refused by both
    with pytest.raises(ValueError, match="exceeds band height"):
        torchme.band_halo_exchange(_stack(plane, bands), 33)


def _jax_banded_me(cur, ref, ru, rv, pmv, qp, bands, halo, real):
    """tests/test_sfe.py's _banded_me harness with each band's real rows
    given: the production banded search over `bands` devices."""
    def per_band(cy, ry, ru_, rv_, real_b):
        mv, py, pu, pv, med = jaxme.me_search_banded(
            cy, ry, ru_, rv_, jnp.asarray(pmv, jnp.int32),
            jnp.asarray(qp, jnp.int32), halo_rows=halo, num_bands=bands,
            axis_name="band", real_rows=real_b[0, 0])
        return mv, py, pu, pv, med[None]

    f = shard_map(per_band, mesh=_band_mesh(bands),
                  in_specs=(P("band"),) * 5, out_specs=(P("band"),) * 5)
    return jax.device_get(jax.jit(f)(
        jnp.asarray(cur, jnp.int16), jnp.asarray(ref, jnp.int16),
        jnp.asarray(ru, jnp.int16), jnp.asarray(rv, jnp.int16),
        jnp.asarray(np.asarray(real, np.int32)[:, None])))


@pytest.mark.parametrize("w,h,bands,halo,last_real", [
    (128, 256, 4, 32, 64),      # the halo covers the search: no clamp
    (128, 128, 2, 16, 64),      # halo 16: vertical centres clamped to 8
    (96, 256, 4, 32, 16)])      # the last band's real rows end early
def test_me_search_banded_matches(w, h, bands, halo, last_real):
    cur, ref, ru, rv = _mixed_motion(w, h, seed=bands)
    Hb = h // bands
    real = [Hb] * (bands - 1) + [last_real]
    pmv, qp = [2, -3], 27
    want = _jax_banded_me(cur, ref, ru, rv, pmv, qp, bands, halo, real)
    got = torchme.me_search_banded(
        _stack(cur, bands), _stack(ref, bands), _stack(ru, bands),
        _stack(rv, bands), torch.tensor(pmv, dtype=torch.int32), qp,
        halo_rows=halo, real_rows=real)
    for name, a, b in zip(("mv", "pred_y", "pred_u", "pred_v"), got, want):
        np.testing.assert_array_equal(
            a.reshape(-1, *a.shape[2:]).numpy(), np.asarray(b),
            err_msg=f"banded search diverges from the reference: {name}")
    # one global median, carried by every band
    assert (np.asarray(want[4]) == got[4].numpy()[None]).all()
    assert len({tuple(v) for v in got[0].reshape(-1, 2).tolist()}) > 1
    if halo == 32 and last_real == Hb:
        # the halo covers the candidate reach: the full-frame search
        full = torchme.me_search(*(torch.from_numpy(a.astype(np.int16))
                                   for a in (cur, ref, ru, rv)),
                                 torch.tensor(pmv, dtype=torch.int32), qp)
        for a, b in zip(got, full):
            np.testing.assert_array_equal(
                a.reshape(b.shape).numpy(), b.numpy())


def test_probe_cost_histogram_and_host_tails_match():
    bands, w, h = 4, 96, 192
    cur, ref, _, _ = _mixed_motion(w, h, seed=11)
    Hb = h // bands
    real = [Hb, Hb, Hb, 32]

    def per_band(cy, ry, real_b):
        return jaxme.banded_probe_cost(cy, ry, real_b[0, 0], "band",
                                       bands)[None]

    f = shard_map(per_band, mesh=_band_mesh(bands),
                  in_specs=(P("band"),) * 3, out_specs=P("band"))
    want = np.asarray(jax.jit(f)(
        jnp.asarray(cur, jnp.int16), jnp.asarray(ref, jnp.int16),
        jnp.asarray(np.asarray(real, np.int32)[:, None])))[0]
    got = torchme.banded_probe_cost(_stack(cur, bands), _stack(ref, bands),
                                    real)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(torchme.probe_center_from_cost(want),
                                  jaxme.probe_center_from_cost(want))
    np.testing.assert_array_equal(
        torchme.banded_coarse_probe(_stack(cur, bands), _stack(ref, bands),
                                    real).numpy(),
        jaxme.probe_center_from_cost(want))
    # the median's histogram over the real MBs of every band
    rng = np.random.default_rng(5)
    mv = rng.integers(-9, 10, (bands, 12, 2)).astype(np.int32)
    mask = np.ones((bands, 12), bool)
    mask[-1, 6:] = False
    cnt_j, n_j = jaxme.hist_counts_banded(
        jnp.asarray(mv.reshape(-1, 2)), jnp.asarray(mask.reshape(-1)), 32,
        None, 1)
    cnt_t, n_t = torchme.hist_counts_banded(torch.from_numpy(mv),
                                            torch.from_numpy(mask), 32)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert int(n_t) == int(n_j) == bands * 12 - 6
    np.testing.assert_array_equal(
        torchme.hist_median_banded(torch.from_numpy(mv),
                                   torch.from_numpy(mask), 32).numpy(),
        jaxme.median_from_counts(cnt_j, n_j, 32))
    np.testing.assert_array_equal(
        torchme.median_from_counts(cnt_t.numpy(), int(n_t), 32),
        jaxme.median_from_counts(np.asarray(cnt_j), int(n_j), 32))


# ---- the band step cores ---------------------------------------------------------

def _band_frames(frames, bands, Hb):
    """Padded (B Hb, W) frame planes, the way SfeShardEncoder stages
    them: edge replication below the picture."""
    out = []
    for y, u, v in frames:
        planes = []
        for p, rows in ((y, bands * Hb), (u, bands * Hb // 2),
                        (v, bands * Hb // 2)):
            pad = rows - p.shape[0]
            planes.append(np.concatenate([p, np.repeat(p[-1:], pad, 0)])
                          if pad else p)
        out.append(planes)
    return out


def _jax_band_steps(frames, bands, mbw, mbh_band, real, qp, rd, halo, total):
    """The reference band cores per band under shard_map: the IDR step
    (sparse and dense), then one P step on its carry."""
    mesh = _band_mesh(bands)
    kw = dict(mbw=mbw, mbh_band=mbh_band, rd=rd, total_mb_rows=total,
              axis_name="band", num_bands=bands)

    def intra(y, u, v, real_b, q):
        dense, rest, (ry, ru, rv, pmv) = jaxinter.sfe_intra_band(
            y, u, v, q, real_b[0, 0], **kw)
        flat, _ = jaxinter.sfe_intra_band_dense(y, u, v, q, real_b[0, 0],
                                                **kw)
        return dense[None], rest[None], flat[None], ry, ru, rv, pmv[None]

    def pstep(y, u, v, ry, ru, rv, pmv, real_b, q):
        mv8, flat, (ry2, ru2, rv2, med) = jaxinter.sfe_p_band(
            y, u, v, (ry, ru, rv, pmv[0]), q, real_b[0, 0],
            halo_rows=halo, **kw)
        return mv8[None], flat[None], ry2, ru2, rv2, med[None]

    band = P("band")
    fi = jax.jit(shard_map(intra, mesh=mesh, in_specs=(band,) * 4 + (P(),),
                           out_specs=(band,) * 7))
    fp = jax.jit(shard_map(pstep, mesh=mesh, in_specs=(band,) * 8 + (P(),),
                           out_specs=(band,) * 6))
    q = jnp.asarray(qp, jnp.int32)
    r = jnp.asarray(np.asarray(real, np.int32)[:, None])
    (y0, u0, v0), (y1, u1, v1) = frames
    iout = fi(jnp.asarray(y0), jnp.asarray(u0), jnp.asarray(v0), r, q)
    pout = fp(jnp.asarray(y1), jnp.asarray(u1), jnp.asarray(v1),
              *iout[3:7], r, q)
    return jax.device_get(iout), jax.device_get(pout)


@pytest.mark.parametrize("rd", ["off", "features"])
def test_band_cores_match_per_band(rd):
    """sfe_intra_band(_dense) and sfe_p_band over the band stack equal the
    reference's per-band programs: levels, MVs, recon carry and median.
    7 MB rows over 3 bands, so the last band carries a padding MB row
    (and, with the features on, the deblock's row masks stop at the
    picture's real rows)."""
    w, h, bands, halo, qp = 96, 112, 3, 32, 27
    mbw, total = w // 16, h // 16
    plan = tplanner.plan_bands(total, mbw, bands)
    mbh_band = plan.band_mb_rows
    Hb = 16 * mbh_band
    real = [b.mb_rows * 16 for b in plan.bands]
    assert real[-1] < Hb
    frames = _band_frames(clip(w, h, 2, seed=3), bands, Hb)
    jrd = jrdo.RdConfig(**RD_FEATURES) if rd == "features" else jrdo.RD_OFF
    trd = trdo.RdConfig(**RD_FEATURES) if rd == "features" else trdo.RD_OFF
    (jdense, jrest, jflat, jry, jru, jrv, jpmv), pwant = _jax_band_steps(
        frames, bands, mbw, mbh_band, real, qp, jrd, halo, total)

    def stack(a, B=bands):
        return torch.from_numpy(np.asarray(a)).reshape(B, -1, a.shape[-1])

    (y0, u0, v0), (y1, u1, v1) = frames
    kw = dict(mbw=mbw, mbh_band=mbh_band, rd=trd, total_mb_rows=total)
    dense, rest, carry = torchinter.sfe_intra_band(
        stack(y0), stack(u0), stack(v0), qp, real, **kw)
    flat, carry_d = torchinter.sfe_intra_band_dense(
        stack(y0), stack(u0), stack(v0), qp, real, **kw)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jdense))
    np.testing.assert_array_equal(rest.numpy(), np.asarray(jrest))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    for got, want in zip(carry[:3], (jry, jru, jrv)):
        np.testing.assert_array_equal(got.reshape(want.shape).numpy(),
                                      np.asarray(want))
    for a, b in zip(carry_d, carry):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(carry[3].numpy()[None].repeat(bands, 0),
                                  np.asarray(jpmv))
    mv8, pflat, (ry2, ru2, rv2, med) = torchinter.sfe_p_band(
        stack(y1), stack(u1), stack(v1), carry, qp, real, halo_rows=halo,
        **kw)
    jmv8, jpflat, jry2, jru2, jrv2, jmed = pwant
    np.testing.assert_array_equal(mv8.numpy(), np.asarray(jmv8))
    np.testing.assert_array_equal(pflat.numpy(), np.asarray(jpflat))
    for got, want in zip((ry2, ru2, rv2), (jry2, jru2, jrv2)):
        np.testing.assert_array_equal(got.reshape(want.shape).numpy(),
                                      np.asarray(want))
    np.testing.assert_array_equal(med.numpy()[None].repeat(bands, 0),
                                  np.asarray(jmed))
    # the P frame really moves: the band search found motion
    assert bool((mv8 != 0).any())


# ---- SfeShardEncoder against the JAX package's -----------------------------------

def _sfe_pair(frames, w, h, qp=27, gop=4, bands=2, halo=32, jrd=None,
              trd=None, gop_qp=None):
    """(JAX encoder, JAX stream, port encoder, port stream) over the same
    frames, recon kept by both."""
    n = len(frames)
    jenc = jdispatch.SfeShardEncoder(
        JMeta(width=w, height=h, num_frames=n), qp=qp, gop_frames=gop,
        bands=bands, halo_rows=halo, rd=jrd)
    tenc = tdispatch.SfeShardEncoder(
        TMeta(width=w, height=h, num_frames=n), qp=qp, gop_frames=gop,
        bands=bands, halo_rows=halo, rd=trd, device="cpu")
    for enc in (jenc, tenc):
        enc.keep_recon = True
        if gop_qp:
            enc.gop_qp.update(gop_qp)
    js = jconcat(jenc.encode([JFrame(*f) for f in frames]))
    ts = tconcat(tenc.encode([TFrame(*f) for f in frames]))
    return jenc, js, tenc, ts


_ENCODER_CASES = {
    # name: (frames, w, h, qp, gop, bands, rd)
    "multi_band": (lambda: clip(64, 128, 6), 64, 128, 27, 3, 4, None),
    "partial_last_band": (lambda: clip(64, 112, 4), 64, 112, 27, 4, 4,
                          None),
    "thin_bands_clamped_halo": (lambda: clip(64, 96, 4, vstep=2), 64, 96,
                                27, 4, 6, None),
    "escape_dense_rerun": (lambda: noise_clip(64, 128, 4), 64, 128, 4, 4,
                           4, None),
    "cropped_display": (lambda: clip(70, 110, 4), 70, 110, 27, 4, 3, None),
    "rd_features": (lambda: clip(96, 112, 4), 96, 112, 27, 4, 3,
                    RD_FEATURES),
    "aq_stripped": (lambda: clip(64, 96, 4), 64, 96, 27, 4, 2,
                    dict(aq_q=4, pskip=True)),
}


@pytest.mark.parametrize("case", list(_ENCODER_CASES))
def test_sfe_encoder_matches_jax(case):
    make, w, h, qp, gop, bands, rd = _ENCODER_CASES[case]
    frames = make()
    n = len(frames)
    jenc, js, tenc, ts = _sfe_pair(
        frames, w, h, qp=qp, gop=gop, bands=bands,
        jrd=jrdo.RdConfig(**rd) if rd else None,
        trd=trdo.RdConfig(**rd) if rd else None)
    assert ts == js
    assert tenc.num_bands == jenc.num_bands == bands
    assert tenc.halo_rows == jenc.halo_rows
    assert dataclasses.astuple(tenc.band_plan) == \
        dataclasses.astuple(jenc.band_plan)
    assert dataclasses.asdict(tenc.rd) == dataclasses.asdict(jenc.rd)
    for i in range(n):
        for a, b, plane in zip(tenc.recon_frames[i], jenc.recon_frames[i],
                               "yuv"):
            np.testing.assert_array_equal(a, b,
                                          err_msg=f"frame {i} recon {plane}")
    tsnap, jsnap = tenc.stages.snapshot(), jenc.stages.snapshot()
    for k in ("sfe_frames", "dense_fallback_waves", "waves"):
        assert tsnap[k] == jsnap[k], k
    assert tsnap["sfe_frames"] == n
    assert len(tenc.frame_done_t) == n
    if case == "thin_bands_clamped_halo":
        assert tenc.halo_rows == 16
    if case == "escape_dense_rerun":
        assert tsnap["dense_fallback_waves"] >= 1
    if case == "partial_last_band":
        assert [b.mb_rows for b in tenc.band_plan.bands] == [2, 2, 2, 1]
    if case == "aq_stripped":
        assert tenc.rd == trdo.RdConfig(pskip=True)


def test_single_band_equals_the_gop_encoder():
    """bands=1 is one slice a frame: the GopShardEncoder's stream at the
    same gop, and the JAX package's encode_gop."""
    w, h, n = 64, 128, 3
    frames = clip(w, h, n)
    _, js, tenc, ts = _sfe_pair(frames, w, h, gop=3, bands=1)
    meta = TMeta(width=w, height=h, num_frames=n)
    gop_enc = tdispatch.GopShardEncoder(meta, qp=27, gop_frames=3,
                                        device="cpu")
    assert ts == js == tconcat(gop_enc.encode([TFrame(*f) for f in frames]))
    assert ts == jencode_gop([JFrame(*f) for f in frames],
                             JMeta(width=w, height=h, num_frames=n), qp=27,
                             idr_pic_id=0)
    assert tenc.num_bands == 1


def test_gop_qp_override_and_slice_layout_match():
    """A per-GOP QP override rides every band slice of the GOP; the
    slices of each picture start at the bands' first MBs."""
    from thinvids_tpu_torch.io.bits import slice_first_mb
    from thinvids_tpu_torch.io.mp4 import split_annexb

    w, h, n = 64, 128, 4
    jenc, js, tenc, ts = _sfe_pair(clip(w, h, n), w, h, gop=2, bands=4,
                                   gop_qp={0: 33})
    assert ts == js
    firsts = [slice_first_mb(u) for u in split_annexb(ts)
              if u[0] & 0x1F in (1, 5)]
    starts = [b.start_mb_row * 4 for b in tenc.band_plan.bands]
    assert firsts == starts * n


def test_sfe_plan_and_latencies():
    meta = TMeta(width=64, height=96, num_frames=1000)
    enc = tdispatch.SfeShardEncoder(meta, gop_frames=4, max_segments=50,
                                    bands=1, device="cpu")
    jenc = jdispatch.SfeShardEncoder(JMeta(width=64, height=96,
                                           num_frames=1000),
                                     gop_frames=4, max_segments=50, bands=1)
    assert dataclasses.astuple(enc.plan(1000)) == \
        dataclasses.astuple(jenc.plan(1000))
    w, h, n = 64, 96, 6
    enc = tdispatch.SfeShardEncoder(TMeta(width=w, height=h, num_frames=n),
                                    gop_frames=3, bands=2, device="cpu")
    tconcat(enc.encode([TFrame(*f) for f in clip(w, h, n)]))
    assert len(enc.frame_done_t) == n
    lats = enc.frame_latencies_ms()
    assert len(lats) == n - 1 and all(v >= 0 for v in lats)
    snap = enc.stages.snapshot()
    assert snap["sfe"] > 0 and snap["sfe_frames"] == n


def test_sfe_band_slice_takes_its_range_of_the_global_layout():
    """A farm band slice (`total_bands`, `band_range`) pins the global
    layout, holds its [lo, hi) bands as its stack with their global band
    indices, leaves the SPS/PPS to the slice that owns band 0, stages
    only its own rows of the frame padded to the GLOBAL grid, and
    refuses deblock — each as the reference's encoder does."""
    w, h = 64, 184                          # 12 MB rows, the last half
    meta = TMeta(width=w, height=h, num_frames=2)
    jmeta = JMeta(width=w, height=h, num_frames=2)
    for kw in (dict(total_bands=3), dict(total_bands=3, band_range=(1, 3)),
               dict(total_bands=5, band_range=(3, 5))):
        enc = tdispatch.SfeShardEncoder(meta, device="cpu", **kw)
        jenc = jdispatch.SfeShardEncoder(jmeta, **kw)
        for attr in ("global_band_plan", "band_plan"):
            assert dataclasses.astuple(getattr(enc, attr)) == \
                dataclasses.astuple(getattr(jenc, attr))
        assert (enc.band_lo, enc.band_hi, enc.emit_parameter_sets,
                enc.halo_rows) == (jenc.band_lo, jenc.band_hi,
                                   jenc.emit_parameter_sets, jenc.halo_rows)
    enc = tdispatch.SfeShardEncoder(meta, gop_frames=2, total_bands=3,
                                    band_range=(1, 3), device="cpu")
    frames = [TFrame(*f) for f in clip(w, h, 2)]
    gop, ys, us, vs, _qp = next(iter(enc.stage_waves(frames)))
    Hb = enc.band_plan.band_mb_rows * 16
    for f, y, u in zip(frames, ys, us):
        padded = np.concatenate([f.y, np.repeat(f.y[-1:], 3 * Hb - h, 0)])
        np.testing.assert_array_equal(y.reshape(2 * Hb, w).numpy(),
                                      padded[Hb:])
        assert u.shape == (2, Hb // 2, w // 2)
    deblock = trdo.RdConfig(deblock=True)
    with pytest.raises(ValueError, match="deblock"):
        tdispatch.SfeShardEncoder(meta, total_bands=3, band_range=(0, 2),
                                  rd=deblock, device="cpu")
    assert tdispatch.SfeShardEncoder(meta, total_bands=3, rd=deblock,
                                     device="cpu").rd.deblock
    with pytest.raises(ValueError, match="empty band range"):
        tdispatch.SfeShardEncoder(meta, total_bands=3, band_range=(3, 3),
                                  device="cpu")


def _ext_blocks(rows, bands, Hp, W):
    """The reference's band-sharded injected input: a (bands·rows, W)
    array whose first band's block is the top rows and whose last band's
    block is the bottom rows (the farm's _ext_device layout)."""
    top, bot = rows
    t = np.zeros((bands * Hp, W), np.int16)
    b = np.zeros((bands * Hp, W), np.int16)
    t[:Hp] = top
    b[(bands - 1) * Hp:] = bot
    return t, b


@pytest.mark.parametrize("lo,hi,halo", [(1, 3, 32), (0, 2, 16), (2, 4, 32)])
def test_farm_slice_search_with_injected_rows_matches(lo, hi, halo):
    """The banded search of a SLICE of a 4-band layout, its neighbour
    rows injected (`ext`, `edge_top`, `edge_bot`), the probe resolved on
    the host and the histogram returned as a partial: equal to the JAX
    package's farm-mode search over the slice's devices, and to the
    whole layout's search on the slice's bands; the slices' probe costs
    and histogram partials sum to the whole layout's."""
    bands, w, h = 4, 96, 256
    cur, ref, ru, rv = _mixed_motion(w, h, seed=lo + 3 * hi)
    Hb = h // bands
    real = [Hb] * bands
    pmv, qp = [2, -3], 27
    B = hi - lo
    edge_top, edge_bot = lo == 0, hi == bands
    y0, y1 = lo * Hb, hi * Hb
    c0, c1 = y0 // 2, y1 // 2
    hc = halo // 2
    rows = {"y": (ref[y0 - halo:y0] if not edge_top else None,
                  ref[y1:y1 + halo] if not edge_bot else None),
            "u": (ru[c0 - hc:c0] if not edge_top else None,
                  ru[c1:c1 + hc] if not edge_bot else None),
            "v": (rv[c0 - hc:c0] if not edge_top else None,
                  rv[c1:c1 + hc] if not edge_bot else None)}
    cost = torchme.banded_probe_cost(_stack(cur, bands), _stack(ref, bands),
                                     real)
    probe = torchme.probe_center_from_cost(cost.numpy())

    # the port: the slice's stack with its edge rows injected
    def inj(a):
        return None if a is None else torch.from_numpy(
            np.asarray(a, np.int16))
    ext = tuple(inj(rows[p][k]) for p in "yuv" for k in (0, 1))
    part = torchme.banded_probe_cost(
        _stack(cur[y0:y1], B), _stack(ref[y0:y1], B), real[lo:hi],
        top_ext=ext[0], bot_ext=ext[1], edge_top=edge_top,
        edge_bot=edge_bot)
    got = torchme.me_search_banded(
        _stack(cur[y0:y1], B), _stack(ref[y0:y1], B),
        _stack(ru[c0:c1], B), _stack(rv[c0:c1], B),
        torch.tensor(pmv, dtype=torch.int32), qp, halo_rows=halo,
        real_rows=real[lo:hi], ext=ext, edge_top=edge_top,
        edge_bot=edge_bot, probe=torch.from_numpy(probe),
        return_hist=True)

    # the reference: the same slice on B devices, in farm mode
    def blocks(p, n):
        top, bot = rows[p]
        z = np.zeros((n, w if p == "y" else w // 2), np.int16)
        return _ext_blocks((z if top is None else top,
                            z if bot is None else bot), B, n,
                           w if p == "y" else w // 2)
    jext = [a for p, n in (("y", halo), ("u", hc), ("v", hc))
            for a in blocks(p, n)]

    def per_band(cy, ry, ru_, rv_, real_b, ty, by, tu, bu, tv, bv):
        edges = (jnp.asarray(edge_top), jnp.asarray(edge_bot))
        mv, py, pu, pv, cnt, n = jaxme.me_search_banded(
            cy, ry, ru_, rv_, jnp.asarray(pmv, jnp.int32),
            jnp.asarray(qp, jnp.int32), halo_rows=halo, num_bands=B,
            axis_name="band", real_rows=real_b[0, 0],
            ext=(ty, by, tu, bu, tv, bv), edge_top=edges[0],
            edge_bot=edges[1], probe=jnp.asarray(probe),
            return_hist=True)
        jcost = jaxme.banded_probe_cost(
            cy, ry, real_b[0, 0], "band", B, top_ext=ty, bot_ext=by,
            edge_top=edges[0], edge_bot=edges[1])
        return mv, py, pu, pv, cnt[None], n.reshape(1), jcost[None]

    f = shard_map(per_band, mesh=_band_mesh(B), in_specs=(P("band"),) * 11,
                  out_specs=(P("band"),) * 7)
    want = jax.device_get(jax.jit(f)(
        jnp.asarray(cur[y0:y1], jnp.int16), jnp.asarray(ref[y0:y1], jnp.int16),
        jnp.asarray(ru[c0:c1], jnp.int16), jnp.asarray(rv[c0:c1], jnp.int16),
        jnp.asarray(np.asarray(real[lo:hi], np.int32)[:, None]),
        *(jnp.asarray(a) for a in jext)))
    for name, a, b in zip(("mv", "pred_y", "pred_u", "pred_v"), got, want):
        np.testing.assert_array_equal(
            a.reshape(-1, *a.shape[2:]).numpy(), np.asarray(b),
            err_msg=f"farm-mode search diverges from the reference: {name}")
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4])[0])
    assert int(got[5]) == int(np.asarray(want[5])[0])
    np.testing.assert_array_equal(part.numpy(), np.asarray(want[6])[0])

    # the whole layout's search, cut to the slice
    full = torchme.me_search_banded(
        _stack(cur, bands), _stack(ref, bands), _stack(ru, bands),
        _stack(rv, bands), torch.tensor(pmv, dtype=torch.int32), qp,
        halo_rows=halo, real_rows=real)
    for a, b in zip(got[:4], full[:4]):
        np.testing.assert_array_equal(a.numpy(), b[lo:hi].numpy())
    # the other slice's partials complete the sums
    rest = [i for i in range(bands) if not lo <= i < hi]
    mvs = full[0].reshape(bands, -1, 2)
    mask = torch.ones(mvs.shape[:2], dtype=torch.bool)
    cnt_all, n_all = torchme.hist_counts_banded(mvs, mask, 32)
    cnt_rest, n_rest = torchme.hist_counts_banded(mvs[rest], mask[rest], 32)
    np.testing.assert_array_equal((got[4] + cnt_rest).numpy(),
                                  cnt_all.numpy())
    assert int(got[5]) + int(n_rest) == int(n_all)
    assert got[4].sum() > 0
    np.testing.assert_array_equal(
        torchme.median_from_counts(cnt_all.numpy(), int(n_all), 32),
        full[4].numpy())
