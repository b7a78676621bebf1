"""Port parity: the PyTorch intra core and device-side transfer pack
(torchcore) against the JAX reference (jaxcore), bit-exact (tolerance
0: integer arithmetic throughout).

The port writes every integer matrix product of the reference (the 4x4
core transform, the luma/chroma DC Hadamards) as explicit butterflies,
because integer matmul does not exist on CUDA in PyTorch; these tests
hold each butterfly to the reference's einsum on the CPU, where both
exist. The same seeded numpy inputs feed both frameworks.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from thinvids_tpu.codecs.h264 import jaxcore
from thinvids_tpu.core.types import Frame as JFrame
from thinvids_tpu_torch.codecs.h264 import torchcore
from thinvids_tpu_torch.core.types import Frame as TFrame

torch.set_num_threads(2)

INTRA_NAMES = ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac",
               "recon_y", "recon_u", "recon_v", "luma_mode", "chroma_mode",
               "qp_delta")


def _planes(w, h, seed=7, noise=False):
    """tests/test_jaxcore.py's gradient + jitter content, or iid noise
    (maximal level density)."""
    rng = np.random.default_rng(seed)
    if noise:
        return (rng.integers(0, 256, (h, w), dtype=np.uint8),
                rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
                rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(((xx * 2 + yy) % 256) + rng.integers(-8, 8, (h, w)),
                0, 255).astype(np.uint8)
    u = np.clip(128 + rng.integers(-20, 20, (h // 2, w // 2)), 0,
                255).astype(np.uint8)
    v = np.clip(128 + rng.integers(-20, 20, (h // 2, w // 2)), 0,
                255).astype(np.uint8)
    return y, u, v


@functools.lru_cache(maxsize=None)
def _jax_intra(mbw, mbh):
    """jaxcore._intra_core (RD off) jitted per shape; qp is traced."""
    return jax.jit(lambda y, u, v, qp: jaxcore._intra_core(
        y, u, v, qp, mbw=mbw, mbh=mbh))


def _compare_intra(y, u, v, qp):
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    want = jax.device_get(_jax_intra(mbw, mbh)(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(qp, jnp.int32)))
    got = torchcore._intra_core(torch.from_numpy(y), torch.from_numpy(u),
                                torch.from_numpy(v), qp, mbw=mbw, mbh=mbh)
    assert len(got) == len(want) == len(INTRA_NAMES)
    for name, a, b in zip(INTRA_NAMES, got, want):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(
            a.numpy(), np.asarray(b),
            err_msg=f"intra core diverges from jaxcore: {name} (qp {qp})")


# ---------------------------------------------------------------------------
# butterflies vs the reference's integer einsums
# ---------------------------------------------------------------------------

def test_transform_butterflies_match_einsums():
    rng = np.random.default_rng(1)
    x = rng.integers(-255, 256, (7, 16, 4, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        torchcore._fwd4(torch.from_numpy(x)).numpy(),
        np.asarray(jaxcore._fwd4(jnp.asarray(x))))
    d = rng.integers(-4000, 4000, (7, 16, 4, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        torchcore._inv4(torch.from_numpy(d)).numpy(),
        np.asarray(jaxcore._inv4(jnp.asarray(d))))


@pytest.mark.parametrize("qp", [0, 4, 17, 29, 35, 36, 41, 51])
def test_dc_quant_dequant_match(qp):
    rng = np.random.default_rng(qp)
    wd = rng.integers(-9000, 9000, (5, 4, 4)).astype(np.int32)
    z = rng.integers(-300, 300, (5, 4, 4)).astype(np.int32)
    zc = rng.integers(-300, 300, (5, 2, 2)).astype(np.int32)
    pairs = [
        (torchcore._luma_dc_quant(torch.from_numpy(wd), qp),
         jaxcore._luma_dc_quant(jnp.asarray(wd), qp)),
        (torchcore._chroma_dc_quant(torch.from_numpy(wd), qp),
         jaxcore._chroma_dc_quant(jnp.asarray(wd), qp)),
        (torchcore._luma_dc_dequant(torch.from_numpy(z), qp),
         jaxcore._luma_dc_dequant(jnp.asarray(z), qp)),
        (torchcore._chroma_dc_dequant(torch.from_numpy(zc), qp),
         jaxcore._chroma_dc_dequant(jnp.asarray(zc), qp)),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"pair {i} at qp {qp}")


# ---------------------------------------------------------------------------
# the intra core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [(64, 48), (96, 32), (16, 16)])
@pytest.mark.parametrize("qp", [4, 10, 27, 40, 51])
def test_intra_core_matches_jax(size, qp):
    w, h = size
    _compare_intra(*_planes(w, h), qp)


@pytest.mark.parametrize("qp", [0, 20])
def test_intra_core_noise_low_qp_matches_jax(qp):
    # iid noise at low qp: the largest levels (luma and chroma DC far
    # past int8) and every block coded
    _compare_intra(*_planes(64, 48, seed=3, noise=True), qp)


def test_intra_core_on_a_padded_frame_matches_jax():
    # 58x37 is no multiple of 16: both packages pad to 64x48 (edge
    # replication) before the core runs
    y, _, _ = _planes(58, 37, seed=11)
    rng = np.random.default_rng(12)
    u, v = (rng.integers(90, 170, (19, 29), dtype=np.uint8)
            for _ in range(2))
    tf = TFrame(y=y, u=u, v=v).padded(16)
    jf = JFrame(y=y, u=u, v=v).padded(16)
    assert tf.y.shape == (48, 64) and tf.u.shape == (24, 32)
    for a, b in ((tf.y, jf.y), (tf.u, jf.u), (tf.v, jf.v)):
        np.testing.assert_array_equal(a, b)
    _compare_intra(tf.y, tf.u, tf.v, 27)


# ---------------------------------------------------------------------------
# the transfer pack: two-tier block sparse + compact byte stream
# ---------------------------------------------------------------------------

_jax_pack2 = jax.jit(jaxcore._block_sparse_pack2)
_jax_compact = jax.jit(jaxcore._compact_stream)


def _pack_both(flat):
    """(counts, used, payload) from jaxcore and torchcore on one flat
    level vector."""
    jn = _jax_pack2(jnp.asarray(flat))
    ju, jp = _jax_compact(jn[0], jn[1], jn[3], jn[4], jn[5])
    tn = torchcore._block_sparse_pack2(torch.from_numpy(flat))
    tu, tp = torchcore._compact_stream(tn[0], tn[1], tn[3], tn[4], tn[5])
    want = ([int(x) for x in jn[:3]], int(ju), np.asarray(jp))
    got = ([int(x) for x in tn[:3]], int(tu), tp.numpy())
    assert tp.dtype == torch.uint8 and tu.dtype == torch.int32
    # the intermediate streams agree too (bmask16 is uint16 in JAX,
    # int32 holding the same values in the port)
    np.testing.assert_array_equal(tn[3].numpy(), np.asarray(jn[3]))
    np.testing.assert_array_equal(tn[4].numpy(),
                                  np.asarray(jn[4]).astype(np.int32))
    np.testing.assert_array_equal(tn[5].numpy(), np.asarray(jn[5]))
    return got, want


def _clustered(L, hot_blocks, max_lanes, seed, lo=-120, hi=121):
    rng = np.random.default_rng(seed)
    flat = np.zeros(L, np.int32)
    nb = L // 16
    for b in rng.choice(nb, hot_blocks, replace=False):
        lanes = rng.choice(16, rng.integers(1, max_lanes + 1),
                           replace=False)
        flat[b * 16 + lanes] = rng.integers(lo, hi, len(lanes))
    return flat


@pytest.mark.parametrize("hot_blocks,max_lanes", [(0, 1), (3, 2), (60, 3),
                                                  (140, 3)])
def test_block_sparse_pack_matches_jax(hot_blocks, max_lanes):
    L = 16 * 600 + 8                   # non-multiple-of-16 tail
    flat = _clustered(L, hot_blocks, max_lanes, seed=hot_blocks)
    got, want = _pack_both(flat)
    assert got[0] == want[0] and got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert torchcore.block_sparse2_fits(*got[0], L)


def test_block_sparse_pack_escape_matches_jax():
    # levels beyond int8: counted in n_esc, which forces the dense
    # fallback; counts and payload must still agree
    L = 16 * 300
    flat = _clustered(L, 40, 4, seed=5)
    flat[[17, 1000, 3333]] = [300, -129, 128]
    got, want = _pack_both(flat)
    assert got[0] == want[0] and got[0][2] == 3
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert not torchcore.block_sparse2_fits(*got[0], L)


@pytest.mark.parametrize("seed", [0, 1])
def test_block_sparse_pack_budget_overflow_matches_jax(seed):
    # dense noise: more live blocks than the block budget and more
    # values than the value budget — the reference drops out-of-range
    # scatter indices, the port clamps them onto a discarded slot
    rng = np.random.default_rng(seed)
    L = 16 * 256 + 5
    flat = rng.integers(-100, 101, L).astype(np.int32)
    flat[rng.random(L) < 0.3] = 0
    got, want = _pack_both(flat)
    nblk, nval, n_esc = got[0]
    assert nblk > (-(-L // 16)) // 4 and nval > L // 24
    assert got[0] == want[0] and got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert not torchcore.block_sparse2_fits(nblk, nval, n_esc, L)
