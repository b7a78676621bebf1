"""Port parity: the PyTorch motion search (torchme) against the JAX
reference (jaxme), bit-exact (tolerance 0: the search is integer
arithmetic end to end).

`torchme.me_search_ref` is the plain version the CUDA kernel is held to
on the card; here it must equal `jaxme.me_search_xla` (the executable
spec the Pallas kernel is tested against) and, on one shape, the Pallas
kernel itself run in the Pallas interpreter. The same seeded numpy
inputs feed both frameworks.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from thinvids_tpu.codecs.h264 import jaxme
from thinvids_tpu_torch.codecs.h264 import torchme

torch.set_num_threads(2)

# the reference programs, jitted once per shape (integer arithmetic: the
# jitted and the eager program give the same bits, and jit is faster
# here than 227 candidates dispatched op by op)
_me_search_xla = jax.jit(jaxme.me_search_xla)
_me_search = jax.jit(jaxme.me_search)


def _mixed_motion_frames(w, h, seed=0):
    """(cur, ref_y, ref_u, ref_v): the left half pans (+3, +3), the
    right half (-2, +1), over textured noise (tests/test_jaxme.py's
    content), so neighbouring MBs pick different candidates."""
    rng = np.random.default_rng(seed)
    pad = 8
    scene = rng.integers(0, 255, (h + 2 * pad, w + 2 * pad)).astype(np.uint8)
    ref = scene[pad:pad + h, pad:pad + w]
    cur = np.empty_like(ref)
    cur[:, :w // 2] = scene[pad + 3:pad + 3 + h, pad + 3:pad + 3 + w // 2]
    cur[:, w // 2:] = scene[pad - 2:pad - 2 + h,
                            pad + w // 2 + 1:pad + w + 1]
    ref_u = rng.integers(0, 255, (h // 2, w // 2)).astype(np.uint8)
    ref_v = rng.integers(0, 255, (h // 2, w // 2)).astype(np.uint8)
    return cur, ref, ref_u, ref_v


def _shifted_frames(w, h, dy, dx, seed):
    """A blocky textured scene (4x4 blobs + grain) and the same scene
    moved by (dy, dx) pel, chroma moved by half that: a pan (small
    motion) or fast motion (a shift at the edge of the search range)."""
    rng = np.random.default_rng(seed)
    pad = 24
    hh, ww = h + 2 * pad, w + 2 * pad
    blobs = rng.integers(30, 220, (hh // 4, ww // 4)).repeat(4, 0).repeat(
        4, 1)
    scene = np.clip(blobs + rng.normal(0, 4, (hh, ww)), 0, 255).astype(
        np.uint8)
    cscene = scene[::2, ::2] // 2 + 64
    ref = scene[pad:pad + h, pad:pad + w]
    cur = scene[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
    cp = pad // 2
    ref_u = cscene[cp:cp + h // 2, cp:cp + w // 2]
    ref_v = 255 - ref_u
    return cur, ref, ref_u, ref_v


CASES = {
    "mixed_128x64": lambda: _mixed_motion_frames(128, 64),
    "mixed_320x32": lambda: _mixed_motion_frames(320, 32),
    "mixed_192x128": lambda: _mixed_motion_frames(192, 128),
    "pan_96x64": lambda: _shifted_frames(96, 64, 2, -3, seed=4),
    "fast_96x64": lambda: _shifted_frames(96, 64, 14, -15, seed=5),
}


def _both(arrs):
    """numpy uint8 planes → (jax int16 list, torch int16 list)."""
    return ([jnp.asarray(a, jnp.int16) for a in arrs],
            [torch.from_numpy(np.asarray(a, np.int16)) for a in arrs])


def _assert_equal(got, want, names):
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b),
            err_msg=f"port diverges from the JAX reference: {name}")


def test_tables_match_reference():
    assert torchme.OFFSET_TABLE == jaxme.OFFSET_TABLE
    assert len(torchme.OFFSET_TABLE) == 227
    np.testing.assert_array_equal(torchme.LAMBDA_H, jaxme.LAMBDA_H)
    assert (torchme.SEARCH_RANGE, torchme._WR, torchme._HR, torchme._ZR,
            torchme._CLIM) == (jaxme.SEARCH_RANGE, jaxme._WR, jaxme._HR,
                               jaxme._ZR, jaxme._CLIM)
    assert torchme.CENTER_CLASSES == jaxme.CENTER_CLASSES
    assert torchme.ZERO_CLASSES == jaxme.ZERO_CLASSES


@pytest.mark.parametrize("case", sorted(CASES))
def test_centers_and_probe_match(case):
    cur, ref, _, _ = CASES[case]()
    (jc, jr), (tc, tr) = _both([cur, ref])
    np.testing.assert_array_equal(
        np.asarray(torchme.coarse_probe(tc, tr)),
        np.asarray(jaxme.coarse_probe(jc, jr)))
    for pmv in ([2, -3], [-40, 61], [0, 0]):
        want = jaxme.centers_from(jc, jr, jnp.asarray(pmv, jnp.int32))
        got = torchme.centers_from(tc, tr,
                                   torch.tensor(pmv, dtype=torch.int32))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_hist_median_matches():
    rng = np.random.default_rng(9)
    for n, spread in ((1, 3), (2, 5), (57, 32), (400, 7)):
        mv = rng.integers(-spread, spread + 1, (n, 2)).astype(np.int32)
        want = jaxme.hist_median(jnp.asarray(mv), 32)
        got = torchme.hist_median(torch.from_numpy(mv), 32)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_me_search_ref_matches_xla(case):
    arrs = CASES[case]()
    (jc, jr, ju, jv), (tc, tr, tu, tv) = _both(arrs)
    centers = jaxme.centers_from(jc, jr, jnp.asarray([2, -3], jnp.int32))
    lam = jnp.asarray(jaxme.LAMBDA_H)[27]
    want = jax.device_get(_me_search_xla(jc, jr, ju, jv, centers,
                                              lam))
    got = torchme.me_search_ref(
        tc, tr, tu, tv, torch.from_numpy(np.array(centers)),
        torchme.lambda_for(27, "cpu"))
    assert [t.dtype for t in got] == [torch.int32] + [torch.int16] * 3
    _assert_equal(got, want, ["mv", "pred_y", "pred_u", "pred_v"])
    if case.startswith("mixed"):
        # the engineered content really did split MB decisions
        assert len({tuple(v) for v in np.asarray(want[0]).reshape(-1, 2)
                    }) > 1


@pytest.mark.parametrize("case", ["pan_96x64", "fast_96x64"])
def test_coinciding_centers_first_candidate_wins(case):
    # probe = median = zero: every window repeats, and only the first
    # occurrence of a duplicate candidate may win
    arrs = CASES[case]()
    (jc, jr, ju, jv), (tc, tr, tu, tv) = _both(arrs)
    for qp in (0, 51):
        lam = jnp.asarray(jaxme.LAMBDA_H)[qp]
        want = jax.device_get(_me_search_xla(
            jc, jr, ju, jv, jnp.zeros((3, 2), jnp.int32), lam))
        got = torchme.me_search_ref(tc, tr, tu, tv,
                                    torch.zeros((3, 2), dtype=torch.int32),
                                    torchme.lambda_for(qp, "cpu"))
        _assert_equal(got, want, ["mv", "pred_y", "pred_u", "pred_v"])


@pytest.mark.parametrize("case,qp", [("mixed_192x128", 27),
                                     ("pan_96x64", 12),
                                     ("fast_96x64", 40)])
def test_me_search_matches_jax_entry(case, qp):
    # the full entry: centres + search + median, CPU tensors take the
    # plain version
    arrs = CASES[case]()
    (jc, jr, ju, jv), (tc, tr, tu, tv) = _both(arrs)
    pmv = [6, -2]
    want = jax.device_get(_me_search(
        jc, jr, ju, jv, jnp.asarray(pmv, jnp.int32),
        jnp.asarray(qp, jnp.int32)))
    got = torchme.me_search(tc, tr, tu, tv,
                            torch.tensor(pmv, dtype=torch.int32), qp)
    _assert_equal(got, want, ["mv", "pred_y", "pred_u", "pred_v", "med"])


def test_me_search_ref_matches_pallas_kernel_interpreted():
    # the production TPU kernel, run as the JAX package's own tests run
    # it on the CPU (Pallas interpreter)
    arrs = CASES["mixed_128x64"]()
    (jc, jr, ju, jv), (tc, tr, tu, tv) = _both(arrs)
    centers = jaxme.centers_from(jc, jr, jnp.asarray([2, -3], jnp.int32))
    lam = jnp.asarray(jaxme.LAMBDA_H)[27]
    want = jax.device_get(jaxme.me_search_pallas(
        jc, jr, ju, jv, centers, lam, interpret=True))
    got = torchme.me_search_ref(
        tc, tr, tu, tv, torch.from_numpy(np.array(centers)),
        torchme.lambda_for(27, "cpu"))
    _assert_equal(got, want, ["mv", "pred_y", "pred_u", "pred_v"])


def test_cuda_wrapper_refuses_cpu_tensors():
    cur, ref, ru, rv = (torch.from_numpy(np.asarray(a, np.int16))
                        for a in CASES["pan_96x64"]())
    launches = torchme.ME_KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        torchme.me_search_cuda(cur, ref, ru, rv,
                               torch.zeros((3, 2), dtype=torch.int32),
                               torchme.lambda_for(27, "cpu"))
    assert torchme.ME_KERNEL_LAUNCHES == launches


# ---------------------------------------------------------------------------
# the CUDA kernels' per-frame half-pel planes: plain version and geometry
# ---------------------------------------------------------------------------

#: reference planes: each CASES reference, and saturating content (the
#: 6-tap overshoots and every clip bites)
_PLANE_REFS = dict(
    {name: (lambda make=make: make()[1]) for name, make in CASES.items()},
    extremes_80x48=lambda: (np.random.default_rng(3).integers(
        0, 2, (48, 80)) * 255).astype(np.uint8))


@pytest.mark.parametrize("case", sorted(_PLANE_REFS))
def test_halfpel_planes_ref_matches_jax_planes(case):
    # the prepass's plain version against jaxme._halfpel_planes on the
    # reference edge-padded as me_search_xla pads it, over the whole
    # margin the wrapper allocates
    ref = _PLANE_REFS[case]()
    H, W = ref.shape
    h = torchme.ME_HALO
    padded = jnp.pad(jnp.asarray(ref, jnp.int16),
                     ((jaxme._PV, jaxme._PV), (jaxme._PH, jaxme._PH)),
                     mode="edge").astype(jnp.int32)
    planes = jaxme._halfpel_planes(
        padded, lambda x, k: jnp.roll(x, k, axis=0),
        lambda x, k: jnp.roll(x, k, axis=1))
    want = np.stack([np.asarray(p)[jaxme._PV - h:jaxme._PV + H + h,
                                   jaxme._PH - h:jaxme._PH + W + h]
                     for p in planes])
    got = torchme.halfpel_planes_ref(torch.from_numpy(ref.astype(np.int16)))
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == (4, H + 2 * h, W + 2 * h)
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)


def test_search_geometry_inside_halo():
    # every candidate of OFFSET_TABLE around every centre |c| <= _CLIM
    # reads its plane inside the margin ME_HALO, from an MB at any edge
    # of the frame; with the 6-tap's -2..+3 reach on top it stays inside
    # the plain version's pads, so the kernel's clamped reads equal them
    h = torchme.ME_HALO
    assert h == torchme._CLIM + torchme._WR
    cents = range(-torchme._CLIM, torchme._CLIM + 1, 2)
    for (_ci, wy, wx) in torchme.OFFSET_TABLE:
        my, mx = wy >> 1, wx >> 1
        # the search kernel stages +-_WR pel around each centre
        assert max(abs(my), abs(mx)) <= torchme._WR
        for axis, (m, half, pad) in enumerate(
                ((my, wy & 1, torchme._PV), (mx, wx & 1, torchme._PH))):
            # a half-pel axis filters -2..+3 samples along it (j is half
            # along both: its vertical pass reads b's unrounded sums)
            tap_lo, tap_hi = (2, 3) if half else (0, 0)
            for c in cents:
                # pixel i of an MB reads plane sample i + c + m: the MB at
                # the top/left edge reaches c + m before the frame's first
                # sample, the one at the bottom/right edge c + m past its
                # last
                assert -h <= c + m <= h, (axis, c, wy, wx)
                assert -pad <= c + m - tap_lo and c + m + tap_hi <= pad


def test_centers_stay_inside_the_clamp():
    # the margin assumes |c| <= _CLIM whatever the carried median says
    cur, ref, _, _ = CASES["fast_96x64"]()
    tc, tr = (torch.from_numpy(np.asarray(a, np.int16)) for a in (cur, ref))
    for pmv in ([1000, -1000], [-99, 77], [47, 49]):
        cents = torchme.centers_from(tc, tr, torch.tensor(pmv,
                                                          dtype=torch.int32))
        assert int(cents.abs().max()) <= torchme._CLIM
        assert not bool((cents % 2).any())


@pytest.mark.parametrize("case", ["mixed_192x128", "fast_96x64"])
def test_search_over_halo_planes_matches_ref(case):
    # the addressing the kernel uses: candidate (ci, wy, wx) of the MB at
    # (y0, x0) reads plane (wy & 1) * 2 + (wx & 1) from row
    # y0 + cy + (wy >> 1) + ME_HALO, column x0 + cx + (wx >> 1) + ME_HALO;
    # a plain search over halfpel_planes_ref with it gives me_search_ref's
    # vectors and luma prediction
    cur, ref, ru, rv = (torch.from_numpy(np.asarray(a, np.int16))
                        for a in CASES[case]())
    H, W = cur.shape
    h = torchme.ME_HALO
    centers = torch.tensor([[12, -12], [-4, 6], [0, 0]], dtype=torch.int32)
    lam = torchme.lambda_for(27, "cpu")
    planes = torchme.halfpel_planes_ref(ref).to(torch.int32)
    c32 = cur.to(torch.int32)
    best = torch.full((H // 16, W // 16), 2**30, dtype=torch.int32)
    bmv = torch.zeros((H // 16, W // 16, 2), dtype=torch.int32)
    pred = torch.zeros((H, W), dtype=torch.int32)
    for (ci, wy, wx) in torchme.OFFSET_TABLE:
        cy, cx = (int(v) for v in centers[ci])
        oy, ox = cy + (wy >> 1) + h, cx + (wx >> 1) + h
        cand = planes[(wy & 1) * 2 + (wx & 1), oy:oy + H, ox:ox + W]
        sad = (c32 - cand).abs().reshape(H // 16, 16, W // 16, 16).sum(
            dim=(1, 3)).to(torch.int32)
        mvy, mvx = 2 * cy + wy, 2 * cx + wx
        cost = sad + int(lam) * (abs(mvy) + abs(mvx))
        take = cost < best
        best = torch.where(take, cost, best)
        bmv[take] = torch.tensor([mvy, mvx], dtype=torch.int32)
        pred = torch.where(take.repeat_interleave(16, 0).repeat_interleave(
            16, 1), cand, pred)
    want = torchme.me_search_ref(cur, ref, ru, rv, centers, lam)
    np.testing.assert_array_equal(bmv.numpy(), want[0].numpy())
    np.testing.assert_array_equal(pred.numpy(), want[1].numpy())


def test_halfpel_cuda_wrapper_refuses_cpu_tensors():
    ref = torch.from_numpy(np.asarray(CASES["pan_96x64"]()[1], np.int16))
    launches = torchme.ME_PREPASS_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        torchme.halfpel_planes_cuda(ref)
    assert torchme.ME_PREPASS_LAUNCHES == launches


def test_search_cuda_wrapper_refuses_cpu_tensors():
    cur, ref, ru, rv = (torch.from_numpy(np.asarray(a, np.int16))
                        for a in CASES["pan_96x64"]())
    launches = torchme.ME_KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        torchme.me_search_planes_cuda(cur, torchme.halfpel_planes_ref(ref),
                                      ru, rv,
                                      torch.zeros((3, 2), dtype=torch.int32),
                                      torchme.lambda_for(27, "cpu"))
    assert torchme.ME_KERNEL_LAUNCHES == launches


# ---------------------------------------------------------------------------
# band stacks: split-frame encoding hands both kernels (B, He, W) stacks
# ---------------------------------------------------------------------------

def _band_stack_inputs(bands=4, halo=16):
    """A (B, He, W) stack of halo-extended bands of one frame, as
    me_search_banded builds it, plus a frame's centres and lambda."""
    cur, ref, ru, rv = (torch.from_numpy(np.asarray(a, np.int16))
                        for a in CASES["mixed_192x128"]())
    cur_s, ref_s, ru_s, rv_s = torchme.extend_bands(
        *(p.reshape(bands, p.shape[0] // bands, p.shape[1])
          for p in (cur, ref, ru, rv)), halo)
    centers = torch.tensor([[12, -12], [-4, 6], [0, 0]], dtype=torch.int32)
    return cur_s, ref_s, ru_s, rv_s, centers, torchme.lambda_for(27, "cpu")


def test_plain_banded_search_is_the_per_band_search():
    # the plain version of a banded launch: me_search_ref and
    # halfpel_planes_ref over a stack equal them band by band, and each
    # band equals the JAX package's search on that band's planes
    cur_s, ref_s, ru_s, rv_s, centers, lam = _band_stack_inputs()
    got = torchme.me_search_ref(cur_s, ref_s, ru_s, rv_s, centers, lam)
    planes = torchme.halfpel_planes_ref(ref_s)
    assert tuple(planes.shape) == (4, 4) + tuple(
        d + 2 * torchme.ME_HALO for d in ref_s.shape[1:])
    for b in range(cur_s.shape[0]):
        want = torchme.me_search_ref(cur_s[b], ref_s[b], ru_s[b], rv_s[b],
                                     centers, lam)
        for a, w in zip(got, want):
            assert torch.equal(a[b], w)
        assert torch.equal(planes[b], torchme.halfpel_planes_ref(ref_s[b]))
        jax_band = jax.device_get(_me_search_xla(
            *(jnp.asarray(t[b].numpy()) for t in (cur_s, ref_s, ru_s, rv_s)),
            jnp.asarray(centers.numpy()), jnp.asarray(jaxme.LAMBDA_H)[27]))
        _assert_equal([a[b] for a in got], jax_band,
                      ["mv", "pred_y", "pred_u", "pred_v"])


def test_banded_wrappers_refuse_cpu_stacks():
    cur_s, ref_s, ru_s, rv_s, centers, lam = _band_stack_inputs()
    counts = (torchme.ME_PREPASS_LAUNCHES, torchme.ME_KERNEL_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        torchme.halfpel_planes_cuda(ref_s)
    with pytest.raises(ValueError, match="CUDA"):
        torchme.me_search_planes_cuda(cur_s, torchme.halfpel_planes_ref(
            ref_s), ru_s, rv_s, centers, lam)
    with pytest.raises(ValueError, match="CUDA"):
        torchme.me_search_cuda(cur_s, ref_s, ru_s, rv_s, centers, lam)
    assert (torchme.ME_PREPASS_LAUNCHES,
            torchme.ME_KERNEL_LAUNCHES) == counts


@pytest.mark.parametrize("fault", ["bands_planes", "bands_chroma",
                                   "stride_cur", "stride_planes",
                                   "stride_ref", "not_a_stack"])
def test_banded_wrappers_refuse_bad_stacks(fault):
    # a stack whose band count differs from cur's, or whose bands do not
    # lie one plane after another, is refused before any launch
    cur_s, ref_s, ru_s, rv_s, centers, lam = _band_stack_inputs()
    planes = torchme.halfpel_planes_ref(ref_s)
    counts = (torchme.ME_PREPASS_LAUNCHES, torchme.ME_KERNEL_LAUNCHES)
    if fault == "stride_ref":
        wide = torch.zeros(ref_s.shape[:2] + (ref_s.shape[2] + 16,),
                           dtype=torch.int16)
        with pytest.raises(ValueError, match="contiguous"):
            torchme.halfpel_planes_cuda(wide[:, :, :ref_s.shape[2]])
    elif fault == "not_a_stack":
        with pytest.raises(ValueError, match="band"):
            torchme.halfpel_planes_cuda(ref_s[None])
    else:
        args = [cur_s, planes, ru_s, rv_s]
        match = "bands"
        if fault == "bands_planes":
            args[1] = planes[:2]
        elif fault == "bands_chroma":
            args[2] = ru_s[1:]
        elif fault == "stride_cur":
            # bands interleaved row by row: (B, He, W) view, band stride W
            args[0] = cur_s.transpose(0, 1).contiguous().transpose(0, 1)
            match = "contiguous"
        else:
            args[1] = planes.transpose(0, 1).contiguous().transpose(0, 1)
            match = "contiguous"
        with pytest.raises(ValueError, match=match):
            torchme.me_search_planes_cuda(*args, centers, lam)
    assert (torchme.ME_PREPASS_LAUNCHES,
            torchme.ME_KERNEL_LAUNCHES) == counts
