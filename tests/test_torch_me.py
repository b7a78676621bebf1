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
