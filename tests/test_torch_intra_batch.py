"""Port parity for the batched intra core: `torchcore.intra_core_batch_ref`
(the plain version of csrc/intra_core.cu's kernel pair) and everything
that now goes through one batched call — `_intra_core` (B = 1), the
all-intra wave, the split-frame IDR band stack — against the JAX
package, bit-exact (tolerance 0: integer arithmetic throughout).

The same seeded numpy inputs feed both frameworks; the reference's
`jaxcore._intra_core` is jitted per shape with its QP traced, as
tests/test_torch_core.py runs it. The kernels themselves need the card:
chip_smoke.py holds them against `intra_core_batch_ref` there; here the
wrapper must refuse CPU tensors and the tables it uploads must be
transform.py's.
"""

import dataclasses
import functools
import pathlib
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from thinvids_tpu.codecs.h264 import jaxcore
from thinvids_tpu.codecs.h264 import rdo as jrdo
from thinvids_tpu.core.types import Frame as JFrame
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu.core.types import concat_segments as jconcat
from thinvids_tpu.parallel import dispatch as jdispatch
from thinvids_tpu_torch.codecs.h264 import rdo as trdo
from thinvids_tpu_torch.codecs.h264 import torchcore, torchinter, torchintra
from thinvids_tpu_torch.codecs.h264 import torchme
from thinvids_tpu_torch.core.types import Frame as TFrame
from thinvids_tpu_torch.core.types import VideoMeta as TMeta
from thinvids_tpu_torch.core.types import concat_segments as tconcat
from thinvids_tpu_torch.parallel import dispatch as tdispatch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CORE7 = ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac", "recon_y",
         "recon_u", "recon_v")
AQ_Q = trdo.aq_from_strength(1.0)


def _content(w, h, seed, kind="grad"):
    """(y, u, v) uint8 planes: tests/test_torch_core.py's gradient +
    jitter content, or iid noise (large, negative coefficients)."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return (rng.integers(0, 256, (h, w), dtype=np.uint8),
                rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
                rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(((xx * (2 + seed % 3) + yy) % 256)
                + rng.integers(-8, 8, (h, w)), 0, 255).astype(np.uint8)
    u = np.clip(128 + rng.integers(-20, 20, (h // 2, w // 2)), 0,
                255).astype(np.uint8)
    v = np.clip(96 + rng.integers(-40, 40, (h // 2, w // 2)), 0,
                255).astype(np.uint8)
    return y, u, v


def _padded(w, h, seed, kind="grad"):
    """The frame padded as the encoders stage it (Frame.padded(16)); the
    port's and the reference's padding must agree."""
    y, u, v = _content(w, h, seed, kind)
    tf = TFrame(y=y, u=u, v=v).padded(16)
    jf = JFrame(y=y, u=u, v=v).padded(16)
    for a, b in zip((tf.y, tf.u, tf.v), (jf.y, jf.u, jf.v)):
        np.testing.assert_array_equal(a, b)
    return tf.y, tf.u, tf.v


@functools.lru_cache(maxsize=None)
def _jax_intra(mbw, mbh, aq_q=0):
    """jaxcore._intra_core jitted per shape (RD off, or AQ only); qp is
    traced."""
    rd = jrdo.RdConfig(aq_q=aq_q) if aq_q else jrdo.RD_OFF
    return jax.jit(lambda y, u, v, qp: jaxcore._intra_core(
        y, u, v, qp, mbw=mbw, mbh=mbh, rd=rd))


def _jax_frame(planes, qp, aq_q=0):
    y, u, v = planes
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    return [np.asarray(a) for a in jax.device_get(_jax_intra(mbw, mbh, aq_q)(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(qp, jnp.int32)))]


def _stack(items):
    return tuple(torch.from_numpy(np.stack([it[i] for it in items]))
                 for i in range(3))


def _assert_batch(got, wants, names=CORE7, tag=""):
    for b, want in enumerate(wants):
        for name, a, w in zip(names, got, want):
            assert a.dtype == torch.int32, name
            np.testing.assert_array_equal(
                a[b].numpy(), w, err_msg=f"{tag} item {b}: {name}")


# ---------------------------------------------------------------------------
# intra_core_batch_ref against the reference, item by item
# ---------------------------------------------------------------------------

_SIZES = {"64x48": (64, 48), "96x64": (96, 64), "padded_72x40": (72, 40)}


@pytest.mark.parametrize("qps", [(12, 27, 40), (51, 36, 35)],
                         ids=["qp12-27-40", "qp51-36-35"])
@pytest.mark.parametrize("size", list(_SIZES))
def test_batch_ref_matches_jax_per_item(size, qps):
    """Three items of different content and QP in one batch; qp 51 and
    36 take _luma_dc_dequant's qp >= 36 branch, 35 the other."""
    w, h = _SIZES[size]
    items = [_padded(w, h, seed=3 * i + 1) for i in range(3)]
    ys, us, vs = _stack(items)
    mbh, mbw = ys.shape[1] // 16, ys.shape[2] // 16
    qp_mb = torch.tensor(qps, dtype=torch.int32)[:, None].expand(
        3, mbw * mbh)
    got = torchcore.intra_core_batch_ref(ys, us, vs, qp_mb, mbw=mbw,
                                         mbh=mbh)
    assert [tuple(a.shape) for a in got] == [
        (3, mbw * mbh, 16), (3, mbw * mbh, 16, 15), (3, mbw * mbh, 2, 4),
        (3, mbw * mbh, 2, 4, 15), (3, 16 * mbh, 16 * mbw),
        (3, 8 * mbh, 8 * mbw), (3, 8 * mbh, 8 * mbw)]
    _assert_batch(got, [_jax_frame(it, q)[:7] for it, q in zip(items, qps)],
                  tag=size)


@pytest.mark.parametrize("qp", [0, 4, 12])
def test_batch_ref_matches_jax_on_noise_at_low_qp(qp):
    """iid noise: large and negative coefficients, DC levels past int8,
    the floor of the luma DC Hadamard's // 2 on negative sums."""
    items = [_content(64, 48, seed=20 + i, kind="noise") for i in range(3)]
    qps = (qp, qp + 1, qp + 2)
    ys, us, vs = _stack(items)
    qp_mb = torch.tensor(qps, dtype=torch.int32)[:, None].expand(3, 12)
    got = torchcore.intra_core_batch_ref(ys, us, vs, qp_mb, mbw=4, mbh=3)
    assert int(got[0].abs().max()) > 127 and int(got[1].min()) < 0
    _assert_batch(got, [_jax_frame(it, q)[:7] for it, q in zip(items, qps)],
                  tag=f"noise qp {qp}")


@pytest.mark.parametrize("aq_q", [AQ_Q, trdo.aq_from_strength(0.5)])
def test_batch_ref_with_an_aq_map_matches_jax(aq_q):
    """The per-MB QP map of variance AQ: intra_core_batch_ref on the
    port's _aq_qp_map, and intra_core_frames(rd=AQ) as a whole, against
    the reference's AQ path (levels, recon, modes and qp_delta)."""
    items = [_content(96, 64, seed=40 + i) for i in range(2)]
    items.append(_content(96, 64, seed=42, kind="noise"))
    qps = (22, 30, 27)
    ys, us, vs = _stack(items)
    mbh, mbw = 4, 6
    qp_mb = torch.stack([
        torchcore._aq_qp_map(ys[b].to(torch.int32), qps[b], aq_q, mbw, mbh)
        for b in range(3)])
    assert int((qp_mb != torch.tensor(qps)[:, None]).sum()) > 0
    wants = [_jax_frame(it, q, aq_q) for it, q in zip(items, qps)]
    got = torchcore.intra_core_batch_ref(ys, us, vs, qp_mb, mbw=mbw,
                                         mbh=mbh)
    _assert_batch(got, [w[:7] for w in wants], tag=f"aq {aq_q}")
    rd = trdo.RdConfig(aq_q=aq_q)
    frames = torchcore.intra_core_frames(ys, us, vs, qps, mbw=mbw, mbh=mbh,
                                         rd=rd)
    _assert_batch(frames, wants, CORE7 + ("luma_mode", "chroma_mode",
                                          "qp_delta"), tag="frames aq")


@pytest.mark.parametrize("rd", ["off", "aq", "mode_decision"])
def test_intra_core_b1_is_unchanged(rd):
    """_intra_core keeps its signature and its ten outputs: RD off and AQ
    through the batched core at B = 1, mode decision through its own
    schedule."""
    y, u, v = _padded(80, 40, seed=5)
    trd = {"off": trdo.RD_OFF, "aq": trdo.RdConfig(aq_q=AQ_Q),
           "mode_decision": trdo.RdConfig(mode_decision=True)}[rd]
    jrd = jrdo.RdConfig(**dataclasses.asdict(trd))
    want = jax.device_get(jax.jit(lambda a, b, c: jaxcore._intra_core(
        a, b, c, jnp.int32(27), mbw=5, mbh=3, rd=jrd))(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v)))
    got = torchcore._intra_core(torch.from_numpy(y), torch.from_numpy(u),
                                torch.from_numpy(v), 27, mbw=5, mbh=3,
                                rd=trd)
    assert len(got) == len(want) == 10
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"{rd}: output {i}")
    if rd == "off":
        ref = torchcore.intra_core_batch_ref(
            *(torch.from_numpy(p)[None] for p in (y, u, v)),
            torch.full((1, 15), 27, dtype=torch.int32), mbw=5, mbh=3)
        for a, b in zip(got[:7], ref):
            assert torch.equal(a, b[0])


def test_one_mb_row_and_one_mb_column():
    """Degenerate chains: a frame one MB high (no column step) and one MB
    wide (row 0 is MB (0, 0) alone)."""
    for w, h in ((80, 16), (16, 64)):
        items = [_content(w, h, seed=60 + i) for i in range(2)]
        ys, us, vs = _stack(items)
        mbh, mbw = h // 16, w // 16
        qp_mb = torch.tensor([[20], [44]], dtype=torch.int32).expand(
            2, mbw * mbh)
        got = torchcore.intra_core_batch_ref(ys, us, vs, qp_mb, mbw=mbw,
                                             mbh=mbh)
        _assert_batch(got, [_jax_frame(it, q)[:7]
                            for it, q in zip(items, (20, 44))],
                      tag=f"{w}x{h}")


def test_intra_core_batch_takes_the_plain_version_on_the_cpu():
    """CPU tensors take intra_core_batch_ref (any integer plane dtype)
    and launch no kernel."""
    torchme.reset_launch_counts()
    items = [_content(48, 32, seed=70 + i) for i in range(2)]
    ys, us, vs = _stack(items)
    qp_mb = torch.full((2, 6), 27, dtype=torch.int32)
    got = torchcore.intra_core_batch(ys.to(torch.int16), us, vs, qp_mb,
                                     mbw=3, mbh=2)
    want = torchcore.intra_core_batch_ref(ys, us, vs, qp_mb, mbw=3, mbh=2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torchintra.INTRA_ROW0_LAUNCHES == 0
    assert torchintra.INTRA_COLS_LAUNCHES == 0
    assert not torchintra.INTRA_ROW0_LAUNCHES_BY_DEVICE


# ---------------------------------------------------------------------------
# the callers: the all-intra wave and the split-frame IDR band stack
# ---------------------------------------------------------------------------

def _wave(G, F, w, h, seed=80):
    frames = [[_padded(w, h, seed + g * F + f) for f in range(F)]
              for g in range(G)]
    return tuple(np.stack([np.stack([fr[i] for fr in gop]) for gop in frames])
                 for i in range(3))


@pytest.mark.parametrize("rd", ["off", "aq"])
def test_encode_wave_matches_jax(rd):
    """dispatch._encode_wave over G = 2 GOPs of F = 3 frames at two QPs
    (one batched intra core for the six frames) and its dense fallback
    equal the reference's per-frame programs."""
    ys, us, vs = _wave(2, 3, 64, 40)
    mbh, mbw = ys.shape[2] // 16, ys.shape[3] // 16
    qps = (27, 33)
    trd = trdo.RdConfig(aq_q=AQ_Q) if rd == "aq" else trdo.RD_OFF
    jrd = jrdo.RdConfig(aq_q=AQ_Q) if rd == "aq" else jrdo.RD_OFF
    mesh = jdispatch.default_mesh(jax.devices()[:1])
    want = jax.device_get(jdispatch._encode_wave(
        jnp.asarray(ys), jnp.asarray(us), jnp.asarray(vs),
        jnp.asarray(qps, jnp.int32), mbw=mbw, mbh=mbh, mesh=mesh, rd=jrd))
    tplanes = [torch.from_numpy(p) for p in (ys, us, vs)]
    got = tdispatch._encode_wave(*tplanes, list(qps), mbw=mbw, mbh=mbh,
                                 rd=trd)
    assert len(got) == len(want) == 6
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"wave output {i}")
    dense = tdispatch._encode_wave_dense(*tplanes, list(qps), mbw=mbw,
                                         mbh=mbh, rd=trd)
    jdense = jax.device_get(jdispatch._encode_wave_dense(
        jnp.asarray(ys), jnp.asarray(us), jnp.asarray(vs),
        jnp.asarray(qps, jnp.int32), mbw=mbw, mbh=mbh, mesh=mesh,
        dtype=jnp.int16, rd=jrd))
    assert dense.dtype == torch.int16
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jdense))


def test_all_intra_stream_at_two_qps_matches_jax():
    """The all-intra encoder (inter=False): 2 GOPs of 3 frames, the
    second GOP's QP overridden — the JAX package's bytes."""
    w, h, n = 64, 40, 6
    clip = [_content(w, h, seed=90 + i) for i in range(n)]
    jenc = jdispatch.GopShardEncoder(
        JMeta(width=w, height=h, num_frames=n), qp=27, gop_frames=3,
        inter=False, mesh=jdispatch.default_mesh(jax.devices()[:1]))
    tenc = tdispatch.GopShardEncoder(
        TMeta(width=w, height=h, num_frames=n), qp=27, gop_frames=3,
        inter=False, device="cpu")
    for enc in (jenc, tenc):
        enc.gop_qp.update({1: 35})
    js = jconcat(jenc.encode([JFrame(*f) for f in clip]))
    ts = tconcat(tenc.encode([TFrame(*f) for f in clip]))
    assert ts == js


def test_sfe_idr_band_stack_matches_jax():
    """A 3-band split-frame encoder whose every frame is an IDR (gop 1):
    each IDR step is one batched core over the band stack; the stream
    is the JAX package's. The stack's levels equal each band alone."""
    w, h, n, bands = 64, 96, 3, 3
    frames = [_content(w, h, seed=100 + i) for i in range(n)]
    jenc = jdispatch.SfeShardEncoder(
        JMeta(width=w, height=h, num_frames=n), qp=27, gop_frames=1,
        bands=bands, halo_rows=16)
    tenc = tdispatch.SfeShardEncoder(
        TMeta(width=w, height=h, num_frames=n), qp=27, gop_frames=1,
        bands=bands, halo_rows=16, device="cpu")
    for enc in (jenc, tenc):
        enc.gop_qp.update({2: 40})
    js = jconcat(jenc.encode([JFrame(*f) for f in frames]))
    ts = tconcat(tenc.encode([TFrame(*f) for f in frames]))
    assert ts == js
    assert tenc.num_bands == bands

    stack = [torch.from_numpy(p).reshape(bands, -1, p.shape[-1])
             for p in frames[0]]
    real = [32] * bands
    dense, rest, _ = torchinter.sfe_intra_band(*stack, 27, real, mbw=4,
                                               mbh_band=2)
    for b in range(bands):
        one = torchcore._intra_core(stack[0][b], stack[1][b], stack[2][b],
                                    27, mbw=4, mbh=2)
        np.testing.assert_array_equal(
            dense[b].numpy(),
            torch.cat([one[0].reshape(-1), one[2].reshape(-1)]).numpy())
        np.testing.assert_array_equal(
            rest[b].numpy(),
            torch.cat([one[1].reshape(-1), one[3].reshape(-1)]).numpy())


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def test_kernel_tables_match_transform():
    """The blob intra_set_tables uploads is the reference's tables, in
    the layout csrc/intra_core.cu reads."""
    blob = torchintra._table_blob()
    src = (ROOT / "thinvids_tpu_torch" / "csrc" / "intra_core.cu").read_text()
    offs = {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+Off|kTablesLen) = (\d+);", src)}
    assert offs["kTablesLen"] == len(blob) == 292
    parts = {
        "kMfOff": np.asarray(jaxcore._MF).reshape(-1),
        "kVOff": np.asarray(jaxcore._V).reshape(-1),
        "kZzOff": np.asarray(jaxcore._ZZ),
        "kIzzOff": np.argsort(np.asarray(jaxcore._ZZ)),
        "kZscanInvOff": np.argsort(np.asarray(jaxcore._ZSCAN)),
        "kQpcOff": np.asarray(jaxcore._QPC),
    }
    for key, want in parts.items():
        o = offs[key]
        np.testing.assert_array_equal(blob[o:o + len(want)], want,
                                      err_msg=key)
    assert sum(len(p) for p in parts.values()) == len(blob)
    # the z-scan inverse puts raster block k where _zigzag(z)[:, zscan]
    # puts it
    zscan = np.asarray(jaxcore._ZSCAN)
    inv = blob[offs["kZscanInvOff"]:offs["kZscanInvOff"] + 16]
    assert all(zscan[inv[k]] == k for k in range(16))


def test_intra_cuda_wrapper_raises_on_cpu_tensors():
    ys = torch.zeros((2, 32, 48), dtype=torch.uint8)
    cs = torch.zeros((2, 16, 24), dtype=torch.uint8)
    qp = torch.full((2, 6), 27, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        torchintra.intra_core_batch_cuda(ys, cs, cs, qp, mbw=3, mbh=2)
    with pytest.raises(ValueError, match="uint8"):
        torchintra.intra_core_batch_cuda(ys.to(torch.int32), cs, cs, qp,
                                         mbw=3, mbh=2)
    with pytest.raises(ValueError, match="int32"):
        torchintra.intra_core_batch_cuda(ys, cs, cs, qp.to(torch.int64),
                                         mbw=3, mbh=2)
    assert torchintra.INTRA_ROW0_LAUNCHES == 0


def test_launch_counts_reset_with_the_me_counts():
    torchintra.INTRA_ROW0_LAUNCHES = 3
    torchintra.INTRA_COLS_LAUNCHES = 3
    torchintra.INTRA_ROW0_LAUNCHES_BY_DEVICE[0] = 3
    torchintra.INTRA_COLS_LAUNCHES_BY_DEVICE[1] = 3
    torchme.reset_launch_counts()
    assert (torchintra.INTRA_ROW0_LAUNCHES, torchintra.INTRA_COLS_LAUNCHES,
            torchintra.INTRA_ROW0_LAUNCHES_BY_DEVICE,
            torchintra.INTRA_COLS_LAUNCHES_BY_DEVICE) == (0, 0, {}, {})
