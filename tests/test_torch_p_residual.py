"""Port parity for the P step's two hand kernels' plain versions:
`torchinter.residual_p_ref` (csrc/p_residual.cu's `p_residual_kernel`)
against `jaxinter._residual_p`, and `torchme.probe_cost_ref` (its
`probe_cost_kernel`), through `coarse_probe` and `banded_probe_cost`,
against `jaxme`'s probe cost and centre. Bit-exact (tolerance 0: integer
arithmetic throughout).

The same seeded numpy inputs feed both frameworks; the reference's
`_residual_p` is jitted per RD config with its QPs traced, as
tests/test_torch_inter.py runs it. The kernels themselves need the card:
chip_smoke.py (phase 3c) holds them against these plain versions there.
Here CPU tensors must never reach the kernels' wrappers, the wrappers
must refuse CPU tensors, and the tables the residual kernel uploads
must be transform.py's.
"""

import functools
import pathlib
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from thinvids_tpu.codecs.h264 import jaxcore, jaxinter, jaxme
from thinvids_tpu.codecs.h264 import rdo as jrdo
from thinvids_tpu.codecs.h264.transform import CHROMA_QP_TABLE
from thinvids_tpu.core.devices import shard_map
from thinvids_tpu_torch.codecs.h264 import rdo as trdo
from thinvids_tpu_torch.codecs.h264 import torchinter, torchme, torchresid

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "thinvids_tpu_torch" / "csrc" / "p_residual.cu"
NAMES = ("luma_levels", "chroma_dc", "chroma_ac", "recon_y", "recon_u",
         "recon_v", "nz4")
QPS = (0, 1, 12, 27, 36, 51)
#: the RD configs the residual runs under: (pskip, deblock)
RDS = {"off": (False, False), "pskip": (True, False),
       "pskip_deblock": (True, True)}


def _qpc(qp):
    return int(CHROMA_QP_TABLE[min(51, max(0, qp))])


def _rd(name):
    pskip, deblock = RDS[name]
    return (trdo.RdConfig(pskip=pskip, deblock=deblock),
            jrdo.RdConfig(pskip=pskip, deblock=deblock))


@functools.lru_cache(maxsize=None)
def _jax_residual(rd_name):
    return jax.jit(functools.partial(
        jaxinter._residual_p, blocked=False, rd=_rd(rd_name)[1]),
        static_argnames=("mbw", "mbh"))


def _mixed(w, h, seed):
    """(cur, pred) int16 planes (y, u, v): textured content whose
    prediction is within ±1 of it in the left half of the MBs, with a
    luma offset of 4 in each MB's first 4x4 block (their levels quantise
    to a single 1 at mid QPs: P_Skip drops them there), and off by up to
    ±40 in the right half (they keep their levels)."""
    rng = np.random.default_rng(seed)
    cur, pred = [], []
    for d in (1, 2, 2):
        hh, ww = h // d, w // d
        yy, xx = np.mgrid[0:hh, 0:ww]
        c = np.clip((xx * 3 + yy * 2) % 200 + 20
                    + rng.integers(-12, 13, (hh, ww)), 0, 255)
        near = c + rng.integers(-1, 2, (hh, ww))
        if d == 1:
            near = near + 4 * ((yy % 16 < 4) & (xx % 16 < 4))
        far = c + rng.integers(-40, 41, (hh, ww))
        p = np.where(xx < ww // 2, near, far)
        cur.append(c.astype(np.int16))
        pred.append(np.clip(p, 0, 255).astype(np.int16))
    return cur, pred


def _extremes(w, h):
    """cur 255 / pred 0 and cur 0 / pred 255 in a checkerboard of MBs:
    the largest residuals of either sign, at the int32 edges of quant and
    dequant."""
    cur, pred = [], []
    for d in (1, 2, 2):
        hh, ww = h // d, w // d
        yy, xx = np.mgrid[0:hh, 0:ww]
        hi = ((yy // (16 // d)) + (xx // (16 // d))) % 2 == 0
        cur.append(np.where(hi, 255, 0).astype(np.int16))
        pred.append(np.where(hi, 0, 255).astype(np.int16))
    return cur, pred


def _both_residuals(cur, pred, qp, rd_name, *, mbw, mbh):
    trd, _ = _rd(rd_name)
    got = torchinter.residual_p_ref(
        *(torch.from_numpy(a) for a in cur + pred), qp, _qpc(qp), mbw=mbw,
        mbh=mbh, rd=trd)
    want = jax.device_get(_jax_residual(rd_name)(
        *(jnp.asarray(a) for a in cur + pred), jnp.int32(qp),
        jnp.int32(_qpc(qp)), mbw=mbw, mbh=mbh))
    return got, want


def _assert_residual(got, want, rd_name, tag):
    assert len(got) == 7 and len(want) == 7
    for name, a, b in zip(NAMES[:6], got, want):
        assert a.dtype == torch.int16, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"{name} {tag}")
    if RDS[rd_name][1]:
        assert got[6].dtype == torch.bool
        np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]),
                                      err_msg=f"nz4 {tag}")
    else:
        assert got[6] is None       # RD off does not compute it


# ---------------------------------------------------------------------------
# the residual core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rd_name", sorted(RDS))
@pytest.mark.parametrize("qp", QPS)
def test_residual_ref_matches_jax(qp, rd_name):
    cur, pred = _mixed(64, 48, seed=qp)
    got, want = _both_residuals(cur, pred, qp, rd_name, mbw=4, mbh=3)
    _assert_residual(got, want, rd_name, f"qp {qp} {rd_name}")


@pytest.mark.parametrize("qp", QPS)
def test_residual_ref_at_extreme_residuals_matches_jax(qp):
    cur, pred = _extremes(64, 48)
    got, want = _both_residuals(cur, pred, qp, "pskip_deblock", mbw=4,
                                mbh=3)
    _assert_residual(got, want, "pskip_deblock", f"extremes qp {qp}")
    # the largest levels of either sign are where the checkerboard says
    lv = got[0].numpy()
    assert lv.max() > 0 > lv.min()


def test_pskip_drops_some_mbs_and_keeps_others():
    """The mixed content at qp 27: P_Skip zeroes every level of some MBs
    that RD off codes, keeps the rest, and their recon is the
    prediction."""
    cur, pred = _mixed(64, 48, seed=27)
    off, _ = _both_residuals(cur, pred, 27, "off", mbw=4, mbh=3)
    on, _ = _both_residuals(cur, pred, 27, "pskip", mbw=4, mbh=3)

    def mass(out):
        y = out[0].numpy().reshape(3, 16, 4, 16)
        return np.abs(y).sum(axis=(1, 3))
    dropped = (mass(on) == 0) & (mass(off) > 0)
    kept = mass(on) > 0
    assert dropped.any() and kept.any()
    recon = on[3].numpy().reshape(3, 16, 4, 16)
    p = pred[0].reshape(3, 16, 4, 16)
    for my, mx in zip(*np.nonzero(dropped)):
        np.testing.assert_array_equal(recon[my, :, mx], p[my, :, mx])


@pytest.mark.parametrize("rd_name", ["off", "pskip_deblock"])
def test_band_stack_as_one_tall_plane_gives_each_band_its_own(rd_name):
    """A 3-band stack of 48 x 96 bands handed over as one (144, 96)
    plane, as sfe_p_band does: each band's rows of every output equal
    the reference's residual on that band alone."""
    bands, hb, w, qp = 3, 48, 96, 27
    cur, pred = _mixed(w, bands * hb, seed=5)
    trd, _ = _rd(rd_name)
    got = torchinter._residual_p(
        *(torch.from_numpy(a) for a in cur + pred), qp, _qpc(qp),
        mbw=w // 16, mbh=bands * hb // 16, rd=trd)
    nmb = (hb // 16) * (w // 16)
    for b in range(bands):
        rows = [slice(b * hb // d, (b + 1) * hb // d) for d in (1, 2, 2)]
        want = jax.device_get(_jax_residual(rd_name)(
            *(jnp.asarray(a[r]) for a, r in zip(cur + pred, rows * 2)),
            jnp.int32(qp), jnp.int32(_qpc(qp)), mbw=w // 16,
            mbh=hb // 16))
        part = (got[0][rows[0]], got[1][:, b * nmb:(b + 1) * nmb],
                got[2][:, rows[1]], got[3][rows[0]], got[4][rows[1]],
                got[5][rows[2]],
                None if got[6] is None else got[6][b * hb // 4:
                                                   (b + 1) * hb // 4])
        _assert_residual(part, want, rd_name, f"band {b}")


# ---------------------------------------------------------------------------
# the global-motion probe's window costs
# ---------------------------------------------------------------------------

def _probe_frames(w, h, seed, shift=(5, -9)):
    """(cur, ref) uint8: a textured scene and the same scene moved by
    `shift` pel, plus grain."""
    rng = np.random.default_rng(seed)
    pad = 24
    scene = rng.integers(0, 256, (h // 4 + 20, w // 4 + 20)).repeat(
        4, 0).repeat(4, 1)
    scene = np.clip(scene + rng.integers(-6, 7, scene.shape), 0, 255)
    dy, dx = shift
    ref = scene[pad:pad + h, pad:pad + w]
    cur = scene[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
    return cur.astype(np.uint8), ref.astype(np.uint8)


def _cells(a):
    h, w = a.shape
    return a.reshape(h // 4, 4, w // 4, 4).astype(np.int64).sum(
        axis=(1, 3)).astype(np.int32)


@pytest.mark.parametrize("shift", [(5, -9), (-12, 16), (0, 0)])
def test_probe_cost_ref_full_frame_matches_jax(shift):
    """The plain probe over one frame's cells, edge-padded by 4 cells,
    against the reference's cost vector (its banded form on one band is
    the full-frame probe's), and coarse_probe's centre against
    jaxme.coarse_probe's."""
    h, w = 64, 96
    cur, ref = _probe_frames(w, h, seed=abs(shift[0]) + 1, shift=shift)
    cq, rq = _cells(cur), _cells(ref)
    got = torchme.probe_cost_ref(
        torch.from_numpy(cq)[None],
        torch.from_numpy(np.pad(rq, 4, mode="edge"))[None],
        torch.ones((1, h // 4), dtype=torch.bool))
    jc, jr = (jnp.asarray(a, jnp.int16) for a in (cur, ref))
    want = np.asarray(jaxme.banded_probe_cost(jc, jr, h, None, 1))
    assert got.dtype == torch.int32 and got.shape == (81,)
    np.testing.assert_array_equal(got.numpy(), want)
    centre = torchme.coarse_probe(*(torch.from_numpy(a.astype(np.int16))
                                    for a in (cur, ref)))
    assert centre.dtype == torch.int32
    np.testing.assert_array_equal(centre.numpy(),
                                  np.asarray(jaxme.coarse_probe(jc, jr)))
    np.testing.assert_array_equal(centre.numpy(),
                                  jaxme.probe_center_from_cost(want))


@pytest.mark.parametrize("bands,real", [(3, (48, 48, 48)),
                                        (4, (48, 48, 48, 20))])
def test_banded_probe_cost_matches_jax(bands, real):
    """banded_probe_cost over a band stack (the last band padded: its
    rows past `real` masked out) against the reference's psum over a
    band mesh, and the centre of the sum."""
    hb, w = 48, 96
    cur, ref = _probe_frames(w, bands * hb, seed=bands, shift=(7, 6))

    def per_band(cy, ry, real_b):
        return jaxme.banded_probe_cost(cy, ry, real_b[0, 0], "band",
                                       bands)[None]

    f = shard_map(per_band, mesh=Mesh(np.array(jax.devices()[:bands]),
                                      ("band",)),
                  in_specs=(P("band"),) * 3, out_specs=P("band"))
    want = np.asarray(jax.jit(f)(
        jnp.asarray(cur, jnp.int16), jnp.asarray(ref, jnp.int16),
        jnp.asarray(np.asarray(real, np.int32)[:, None])))[0]

    def stack(a):
        return torch.from_numpy(a.astype(np.int16)).reshape(bands, hb, w)
    got = torchme.banded_probe_cost(stack(cur), stack(ref), list(real))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        torchme.banded_coarse_probe(stack(cur), stack(ref),
                                    list(real)).numpy(),
        jaxme.probe_center_from_cost(want))


def test_probe_cost_ref_masks_rows_and_wraps_as_int32():
    """Masked rows add nothing; the sum wraps as an int32 sum does (the
    kernel adds into uint32, the same bits), whatever the order."""
    rng = np.random.default_rng(3)
    cq = rng.integers(0, 4081, (2, 8, 12)).astype(np.int32)
    rq = rng.integers(0, 4081, (2, 16, 20)).astype(np.int32)
    mask = np.ones((2, 8), bool)
    mask[1, 5:] = False
    got = torchme.probe_cost_ref(torch.from_numpy(cq), torch.from_numpy(rq),
                                 torch.from_numpy(mask)).numpy()
    want = np.asarray([
        (np.abs(cq - rq[:, oy:oy + 8, ox:ox + 12]) * mask[:, :, None]).sum()
        for oy in range(9) for ox in range(9)])
    np.testing.assert_array_equal(got, want.astype(np.int32))
    big = np.full((1, 8, 12), 1 << 30, np.int32)
    zero = np.zeros((1, 16, 20), np.int32)
    got = torchme.probe_cost_ref(torch.from_numpy(big),
                                 torch.from_numpy(zero),
                                 torch.ones((1, 8), dtype=torch.bool))
    assert got.dtype == torch.int32
    assert (got.numpy() == np.int64(96 << 30).astype(np.int32)).all()


# ---------------------------------------------------------------------------
# the kernels' wrappers and the dispatch
# ---------------------------------------------------------------------------

def test_kernel_tables_match_transform():
    """The blob p_set_tables uploads is the reference's MF and V, in the
    layout csrc/p_residual.cu reads; its probe radius is the search's."""
    blob = torchresid._table_blob()
    src = SOURCE.read_text()
    offs = {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+Off|kTablesLen) = (\d+);", src)}
    assert offs["kTablesLen"] == len(blob) == 192
    parts = {"kMfOff": np.asarray(jaxcore._MF).reshape(-1),
             "kVOff": np.asarray(jaxcore._V).reshape(-1)}
    for key, want in parts.items():
        o = offs[key]
        np.testing.assert_array_equal(blob[o:o + len(want)], want,
                                      err_msg=key)
    assert sum(len(p) for p in parts.values()) == len(blob)
    qsr = int(re.search(r"constexpr int kQsr = (\d+);", src).group(1))
    assert qsr == jaxme.SEARCH_RANGE // jaxme._COARSE == \
        torchme.SEARCH_RANGE // torchme._COARSE
    assert re.search(r"int pskip_sum", src) and trdo.PSKIP_SUM == \
        jrdo.PSKIP_SUM


@pytest.fixture
def refuse_kernels(monkeypatch):
    """The kernels' wrappers, replaced by recorders that fail the test if
    a CPU path reaches them."""
    calls = []

    def record(name):
        def fn(*args, **kw):
            calls.append(name)
            raise AssertionError(f"{name} called on the CPU")
        return fn
    monkeypatch.setattr(torchresid, "residual_p_cuda",
                        record("residual_p_cuda"))
    monkeypatch.setattr(torchresid, "probe_cost_cuda",
                        record("probe_cost_cuda"))
    torchme.reset_launch_counts()
    yield calls
    assert calls == []
    assert (torchresid.P_RESIDUAL_LAUNCHES, torchresid.PROBE_LAUNCHES,
            torchresid.P_RESIDUAL_LAUNCHES_BY_DEVICE,
            torchresid.PROBE_LAUNCHES_BY_DEVICE) == (0, 0, {}, {})


def test_cpu_paths_never_reach_the_kernels(refuse_kernels):
    """A CPU GOP program (an IDR and two P frames, RD off and P_Skip +
    deblock), a CPU split-frame P step and the probes take the plain
    versions and equal them."""
    w, h = 64, 48
    rng = np.random.default_rng(9)
    ys = torch.from_numpy(rng.integers(0, 256, (3, h, w), dtype=np.uint8))
    us = torch.from_numpy(rng.integers(0, 256, (3, h // 2, w // 2),
                                       dtype=np.uint8))
    vs = us.flip(1).contiguous()
    for rd_name in ("off", "pskip_deblock"):
        torchinter.encode_gop_planes(ys, us, vs, 27, mbw=4, mbh=3,
                                     rd=_rd(rd_name)[0])
    cur, pred = _mixed(w, h, seed=4)
    args = [torch.from_numpy(a) for a in cur + pred]
    got = torchinter._residual_p(*args, 27, _qpc(27), mbw=4, mbh=3,
                                 rd=_rd("pskip_deblock")[0])
    want = torchinter.residual_p_ref(*args, 27, _qpc(27), mbw=4, mbh=3,
                                     rd=_rd("pskip_deblock")[0])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    c16 = ys.to(torch.int16)
    torchme.coarse_probe(c16[1], c16[0])
    torchme.banded_probe_cost(c16[1].reshape(3, 16, w),
                              c16[0].reshape(3, 16, w), [16, 16, 16])
    carry = (c16[0].reshape(3, 16, w),
             us[0].to(torch.int16).reshape(3, 8, w // 2),
             vs[0].to(torch.int16).reshape(3, 8, w // 2),
             torch.zeros(2, dtype=torch.int32))
    torchinter.sfe_p_band(ys[1].reshape(3, 16, w),
                          us[1].reshape(3, 8, w // 2),
                          vs[1].reshape(3, 8, w // 2), carry, 27,
                          [16, 16, 16], mbw=4, mbh_band=1, halo_rows=16,
                          total_mb_rows=3)


def test_resid_cuda_wrappers_raise_on_cpu_tensors():
    torchme.reset_launch_counts()
    y = torch.zeros((48, 64), dtype=torch.int16)
    c = torch.zeros((24, 32), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        torchresid.residual_p_cuda(y, c, c, y, c, c, 27, 29, mbw=4, mbh=3)
    with pytest.raises(ValueError, match="int16"):
        torchresid.residual_p_cuda(y.to(torch.int32), c, c, y, c, c, 27,
                                   29, mbw=4, mbh=3)
    with pytest.raises(ValueError, match="contiguous"):
        torchresid.residual_p_cuda(y, c.t().contiguous().t(), c, y, c, c,
                                   27, 29, mbw=4, mbh=3)
    cq = torch.zeros((1, 12, 16), dtype=torch.int32)
    rq = torch.zeros((1, 20, 24), dtype=torch.int32)
    mask = torch.ones((1, 12), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        torchresid.probe_cost_cuda(cq, rq, mask)
    with pytest.raises(ValueError, match="rq_ext"):
        torchresid.probe_cost_cuda(cq, rq[:, :18].contiguous(), mask)
    with pytest.raises(ValueError, match="mask"):
        torchresid.probe_cost_cuda(cq, rq, mask.to(torch.int32))
    assert torchresid.P_RESIDUAL_LAUNCHES == torchresid.PROBE_LAUNCHES == 0


def test_launch_counts_reset_with_the_me_counts():
    torchresid.P_RESIDUAL_LAUNCHES = 3
    torchresid.PROBE_LAUNCHES = 3
    torchresid.P_RESIDUAL_LAUNCHES_BY_DEVICE[0] = 3
    torchresid.PROBE_LAUNCHES_BY_DEVICE[1] = 3
    torchme.reset_launch_counts()
    assert (torchresid.P_RESIDUAL_LAUNCHES, torchresid.PROBE_LAUNCHES,
            torchresid.P_RESIDUAL_LAUNCHES_BY_DEVICE,
            torchresid.PROBE_LAUNCHES_BY_DEVICE) == (0, 0, {}, {})
