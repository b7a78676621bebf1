"""Port parity: the PyTorch P-frame compute and closed-GOP program
(torchinter) against the JAX reference (jaxinter), bit-exact (tolerance
0).

The P step takes its carry — the previous recon planes and the previous
frame's median MV — as explicit tensors, so a test can feed it the JAX
program's own carry from the middle of a GOP and compare one step. The
same seeded numpy inputs feed both frameworks.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from thinvids_tpu.codecs.h264 import jaxinter, jaxme
from thinvids_tpu.codecs.h264.transform import CHROMA_QP_TABLE
from thinvids_tpu_torch.codecs.h264 import torchcore, torchinter, torchme

torch.set_num_threads(2)

W, H, F = 64, 48, 4
MBW, MBH = W // 16, H // 16


def _gop(seed=0, n=F, w=W, h=H, step=(2, 3)):
    """(ys, us, vs) uint8 (n, h, w) / (n, h/2, w/2): a blocky textured
    scene panning `step` pel per frame, with fresh grain every frame."""
    rng = np.random.default_rng(seed)
    pad = 8 + max(step) * n
    hh, ww = h + pad, w + pad
    blobs = rng.integers(30, 220, (hh // 4 + 1, ww // 4 + 1)).repeat(
        4, 0).repeat(4, 1)[:hh, :ww]
    ys, us, vs = [], [], []
    for i in range(n):
        dy, dx = step[0] * i, step[1] * i
        y = blobs[dy:dy + h, dx:dx + w] + rng.normal(0, 3, (h, w))
        ys.append(np.clip(y, 0, 255).astype(np.uint8))
        c = blobs[dy:dy + h:2, dx:dx + w:2]
        us.append(np.clip(c // 2 + 60, 0, 255).astype(np.uint8))
        vs.append(np.clip(200 - c // 3, 0, 255).astype(np.uint8))
    return np.stack(ys), np.stack(us), np.stack(vs)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax_gop_recon():
    """encode_gop_jit with the per-frame recon emitted (the carry)."""
    return jax.jit(functools.partial(jaxinter.encode_gop_jit, mbw=MBW,
                                     mbh=MBH, emit_recon=True))


# the reference's P-frame programs, jitted once per shape
_residual_p = jax.jit(jaxinter._residual_p,
                      static_argnames=("mbw", "mbh", "blocked"))
_encode_p_plane = jax.jit(jaxinter._encode_p_plane,
                          static_argnames=("mbw", "mbh", "blocked"))
_encode_gop_planes = jax.jit(jaxinter.encode_gop_planes,
                             static_argnames=("mbw", "mbh"))


def _qpc(qp):
    return int(CHROMA_QP_TABLE[min(51, max(0, qp))])


@pytest.mark.parametrize("qp", [6, 27, 45])
def test_residual_p_matches_jax(qp):
    ys, us, vs = _gop(seed=qp)
    rng = np.random.default_rng(qp + 100)
    # any prediction planes will do: the residual core is per-MB math
    py = np.clip(ys[1].astype(np.int32) + rng.integers(-9, 10, ys[1].shape),
                 0, 255).astype(np.int16)
    pu = us[0].astype(np.int16)
    pv = np.clip(vs[1].astype(np.int32) + 3, 0, 255).astype(np.int16)
    cy, cu, cv = (a[1].astype(np.int16) for a in (ys, us, vs))
    want = jax.device_get(_residual_p(
        jnp.asarray(cy), jnp.asarray(cu), jnp.asarray(cv), jnp.asarray(py),
        jnp.asarray(pu), jnp.asarray(pv), jnp.asarray(qp, jnp.int32),
        jnp.asarray(_qpc(qp), jnp.int32), mbw=MBW, mbh=MBH,
        blocked=False))
    got = torchinter._residual_p(_t(cy), _t(cu), _t(cv), _t(py), _t(pu),
                                 _t(pv), qp, _qpc(qp), mbw=MBW, mbh=MBH)
    names = ("luma_levels", "chroma_dc", "chroma_ac", "recon_y", "recon_u",
             "recon_v")
    # the seventh output, nz4, feeds only the deblocking filter: RD off
    # does not compute it (its parity is tests/test_torch_rdo.py's)
    assert len(got) == len(names) + 1 and got[6] is None
    for name, a, b in zip(names, got, want[:6]):
        assert a.dtype == torch.int16, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"{name} at qp {qp}")


@pytest.mark.parametrize("k", [2, 3])
def test_p_step_fed_the_jax_carry_matches(k):
    # the JAX GOP program's carry entering P frame k (recon of frame
    # k-1, median MV of frame k-1), fed to both P steps
    qp = 27
    ys, us, vs = _gop(seed=3)
    _, (mv, _, _, _), (ry, ru, rv) = jax.device_get(_jax_gop_recon()(
        jnp.asarray(ys), jnp.asarray(us), jnp.asarray(vs),
        jnp.asarray(qp, jnp.int32)))
    pred_mv = np.asarray(jaxme.hist_median(jnp.asarray(mv[k - 2]), 32))
    carry = [np.asarray(a[k - 1], np.int16) for a in (ry, ru, rv)]
    want = jax.device_get(_encode_p_plane(
        jnp.asarray(ys[k]), jnp.asarray(us[k]), jnp.asarray(vs[k]),
        *[jnp.asarray(c) for c in carry], jnp.asarray(pred_mv),
        jnp.asarray(qp, jnp.int32), jnp.asarray(_qpc(qp), jnp.int32),
        mbw=MBW, mbh=MBH, blocked=False))
    got = torchinter._encode_p_plane(
        _t(ys[k]), _t(us[k]), _t(vs[k]), *[_t(c) for c in carry],
        _t(pred_mv), qp, _qpc(qp), mbw=MBW, mbh=MBH)
    names = ("mv", "luma_levels", "chroma_dc", "chroma_ac", "recon_y",
             "recon_u", "recon_v", "med_mv")
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"P frame {k}: {name}")
    # the step really moved: the pan is found, not the zero vector
    assert np.abs(got[0].numpy()).max() > 0
    # and the JAX program's own next-frame carry is what the port emits
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ry[k]))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(ru[k]))
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(rv[k]))


@pytest.mark.parametrize("qp,frames", [(27, F), (14, F), (33, 1)])
def test_encode_gop_planes_matches_jax(qp, frames):
    ys, us, vs = (a[:frames] for a in _gop(seed=qp))
    want_mv8, want_flat = jax.device_get(_encode_gop_planes(
        jnp.asarray(ys), jnp.asarray(us), jnp.asarray(vs),
        jnp.asarray(qp, jnp.int32), mbw=MBW, mbh=MBH))
    got_mv8, got_flat = torchinter.encode_gop_planes(
        _t(ys), _t(us), _t(vs), qp, mbw=MBW, mbh=MBH)
    assert got_mv8.dtype == torch.int8 and got_flat.dtype == torch.int16
    assert tuple(got_mv8.shape) == (frames - 1, MBW * MBH, 2)
    np.testing.assert_array_equal(got_mv8.numpy(), np.asarray(want_mv8))
    np.testing.assert_array_equal(got_flat.numpy(), np.asarray(want_flat))


def test_plane_transforms_match_jax():
    rng = np.random.default_rng(2)
    x = rng.integers(-255, 256, (16, 32)).astype(np.int32)
    d = rng.integers(-5000, 5000, (16, 32)).astype(np.int32)
    for fn in ("_fwd4_axis0", "_fwd4_axis1", "_fwd4_plane"):
        np.testing.assert_array_equal(
            getattr(torchinter, fn)(_t(x)).numpy(),
            np.asarray(getattr(jaxinter, fn)(jnp.asarray(x))), err_msg=fn)
    for fn in ("_inv4_axis0", "_inv4_axis1", "_inv4_plane"):
        np.testing.assert_array_equal(
            getattr(torchinter, fn)(_t(d)).numpy(),
            np.asarray(getattr(jaxinter, fn)(jnp.asarray(d))), err_msg=fn)
    # the plane transform is the blocked one, block by block
    blocks = x.reshape(4, 4, 8, 4).transpose(0, 2, 1, 3)
    np.testing.assert_array_equal(
        torchinter._fwd4_plane(_t(x)).numpy().reshape(4, 4, 8, 4)
        .transpose(0, 2, 1, 3),
        torchcore._fwd4(_t(blocks)).numpy())
    assert torchme.SEARCH_RANGE == torchinter.SEARCH_RANGE
