"""The reference's sharding suite, tests/test_parallel.py (the GOP
planner, the sharded dispatch, its sparse and dense transfers, the host
pack pipeline), run over the port on an 8-entry CPU mesh.

The reference module is read with every `thinvids_tpu` import naming
`thinvids_tpu_torch` (tests/test_torch_job_suites.py's `reference_cases`)
and ``use_jax=`` as the port's ``use_device=``: its expected streams
come from `_reference_stream`, which encodes each frame with the numpy
specification (``H264Encoder(..., use_device=False)``) in the GOP plan
of `len(jax.devices())` devices — the conftest's 8 virtual CPU devices.
The port's ``mesh=None`` is one card (ROADMAP C, deliberate
differences), which would plan a different GOP layout; so here, unlike
tests/test_torch_job_suites.py's one-entry stand-ins, `GopShardEncoder`,
`encode_clip_sharded` and `default_mesh` are the port's on
``DeviceMesh(("cpu",) * 8)``: the plan and the bytes are the
reference's 8-wide ones. `encode_gop` and `H264Encoder` run with
``device="cpu"``; ``jaxcore`` reads as ``torchcore`` (the port's home of
`block_sparse2_fits`, which a case forces false).

Left out by name, because each calls JAX itself; the port test that
takes each one's place is below, on the same content and seed:

- ``TestShardedDispatch.test_mesh_has_8_virtual_devices`` →
  `test_stand_in_mesh_has_8_cpu_entries`;
- ``TestShardedDispatch.test_sparse_pack_roundtrip`` (``jaxcore._sparse_pack``
  on ``jnp``) → `test_sparse_pack_roundtrip`;
- ``TestShardedInterDispatch.test_low_qp_stays_on_sparse_path``
  (``jaxinter.encode_gop_planes`` on ``jnp``) →
  `test_low_qp_stays_on_sparse_path`;
- ``TestShardedInterDispatch.test_block_sparse2_roundtrip`` →
  `test_block_sparse2_roundtrip`;
- ``TestShardedInterDispatch.test_block_sparse2_escape_forces_dense`` →
  `test_block_sparse2_escape_forces_dense`;
- ``TestHostPipeline.test_native_sparse_unpack_matches_python``
  (``jaxcore._block_sparse_unpack2``) →
  `test_native_sparse_unpack_matches_python`;
- ``TestHostPipeline.test_pack_gop_slices_planes_matches_thunk_path``
  (``jaxinter.encode_gop_planes`` on ``jnp``) →
  `test_pack_gop_slices_planes_matches_thunk_path`.

Tolerance: 0 (equal bytes, equal arrays).
"""

import concurrent.futures as cf
import functools

import numpy as np
import pytest
import torch

from tests.test_torch_job_suites import collect, on_the_cpu, reference_cases
from thinvids_tpu_torch import native as tnative
from thinvids_tpu_torch.codecs.h264 import encoder as tencoder
from thinvids_tpu_torch.codecs.h264 import layout, torchcore, torchinter
from thinvids_tpu_torch.codecs.h264.headers import PPS, SPS
from thinvids_tpu_torch.core.devices import DeviceMesh
from thinvids_tpu_torch.core.types import Frame, VideoMeta
from thinvids_tpu_torch.parallel import dispatch as tdispatch
from thinvids_tpu_torch.parallel.planner import plan_segments

torch.set_num_threads(1)

#: the reference's test mesh: 8 devices (tests/conftest.py)
MESH8 = DeviceMesh(("cpu",) * 8)


class GopShardEncoder8(tdispatch.GopShardEncoder):
    """The port's encoder on the CPU, on MESH8 unless told otherwise."""

    def __init__(self, *args, device="cpu", mesh=None, **kw):
        super().__init__(*args, device=device,
                         mesh=MESH8 if mesh is None else mesh, **kw)


GopShardEncoder8.__name__ = GopShardEncoder8.__qualname__ = "GopShardEncoder"

#: module attribute → its CPU stand-in, in the port's modules and in the
#: namespace of the reference module executed here
MESH_STANDINS = {
    (tdispatch, "GopShardEncoder"): GopShardEncoder8,
    (tdispatch, "encode_clip_sharded"): functools.partial(
        tdispatch.encode_clip_sharded, device="cpu", mesh=MESH8),
    (tdispatch, "default_mesh"):
        lambda devices=None: MESH8 if devices is None
        else DeviceMesh(devices),
    (tencoder, "encode_gop"):
        functools.partial(tencoder.encode_gop, device="cpu"),
    (tencoder, "H264Encoder"): on_the_cpu(tencoder.H264Encoder),
}


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    for (owner, attr), standin in MESH_STANDINS.items():
        monkeypatch.setattr(owner, attr, standin)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


collect(reference_cases(
    "test_parallel", ((r"\buse_jax=", "use_device="),
                      (r"\bjaxcore\b", "torchcore")), MESH_STANDINS),
    globals(), leave_out={
        "TestShardedDispatch.test_mesh_has_8_virtual_devices",
        "TestShardedDispatch.test_sparse_pack_roundtrip",
        "TestShardedInterDispatch.test_low_qp_stays_on_sparse_path",
        "TestShardedInterDispatch.test_block_sparse2_roundtrip",
        "TestShardedInterDispatch.test_block_sparse2_escape_forces_dense",
        "TestHostPipeline.test_native_sparse_unpack_matches_python",
        "TestHostPipeline.test_pack_gop_slices_planes_matches_thunk_path",
    })


def _make_frames(n, w=64, h=48, seed=0):
    """tests/test_parallel.py's iid-noise frames."""
    rng = np.random.default_rng(seed)
    return [Frame(
        y=rng.integers(0, 256, (h, w), dtype=np.uint8),
        u=rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
        v=rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
    ) for _ in range(n)]


def _numpy(tensors):
    return [t.numpy() for t in tensors]


def test_stand_in_mesh_has_8_cpu_entries():
    enc = tdispatch.GopShardEncoder(VideoMeta(width=64, height=48,
                                              num_frames=16), qp=27)
    assert enc.num_devices == 8
    assert enc.mesh.devices == (torch.device("cpu"),) * 8


def test_sparse_pack_roundtrip():
    rng = np.random.default_rng(0)
    L = 3840
    flat = np.zeros(L, np.int32)
    nz = rng.choice(L, size=L // 8, replace=False)
    flat[nz] = rng.integers(-127, 128, size=L // 8)
    flat[nz[0]] = 0       # make one chosen slot zero again
    flat[nz[1]] = 400     # escape: exceeds int8
    flat[nz[2]] = -1900   # escape, negative
    nnz, n_esc, bitmap, vals, esc_pos, esc_val = _numpy(
        torchcore._sparse_pack(torch.from_numpy(flat)))
    assert int(n_esc) == 2
    assert torchcore.sparse_fits(nnz, n_esc, L)
    out = torchcore._sparse_unpack(int(nnz), int(n_esc), bitmap, vals,
                                   esc_pos, esc_val, L)
    np.testing.assert_array_equal(out, flat)


def test_low_qp_stays_on_sparse_path(monkeypatch):
    """Saturated chroma drives intra chroma DC past int8 at QP 15; the
    port's low-QP sharded encode keeps the sparse transfer (its dense
    fallbacks raise here) and equals the per-GOP `encode_gop` stream."""
    def boom(*a, **k):
        raise AssertionError("dense fallback taken at low QP")

    monkeypatch.setattr(tdispatch, "_encode_gop_single_dense", boom)
    monkeypatch.setattr(tdispatch, "_encode_wave_dense", boom)
    w, h, n = 64, 48, 8
    yy, xx = np.mgrid[0:h, 0:w]
    frames = [Frame(
        y=np.clip(xx // 4 * 2 + 60 + 2 * i, 0, 255).astype(np.uint8),
        u=np.full((h // 2, w // 2), 235, np.uint8),
        v=np.full((h // 2, w // 2), 20, np.uint8),
    ) for i in range(n)]
    meta = VideoMeta(width=w, height=h, num_frames=n)

    # the trap is armed: intra chroma DC escapes int8
    nmb = (w // 16) * (h // 16)
    _mv, flat = torchinter.encode_gop_planes(
        *(torch.from_numpy(np.stack([getattr(f, c) for f in frames[:2]]))
          for c in "yuv"), 15, mbw=w // 16, mbh=h // 16)
    cdc = flat.numpy()[nmb * 256:nmb * 264]
    assert np.abs(cdc).max() > 127
    got = tdispatch.encode_clip_sharded(frames, meta, qp=15, gop_frames=2)
    plan = plan_segments(n, 2, MESH8.size)
    parts = [tencoder.encode_gop(frames[g.start_frame:g.end_frame], meta,
                                 qp=15, idr_pic_id=g.index)
             for g in plan.gops]
    assert got == b"".join(parts)


def _clustered(rng, L, n_blocks, n_hot, max_lanes):
    """Residual-like content: nonzeros cluster in a few 16-coeff blocks."""
    flat = np.zeros(L, np.int32)
    for b in rng.choice(n_blocks, n_hot, replace=False):
        lanes = rng.choice(16, rng.integers(1, max_lanes), replace=False)
        flat[b * 16 + lanes] = rng.integers(-120, 121, len(lanes))
    return flat


def test_block_sparse2_roundtrip():
    rng = np.random.default_rng(5)
    L = 16 * 1000 + 8
    flat = _clustered(rng, L, 200, 120, 6)
    nblk, nval, n_esc, bitmap, bmask16, vals = _numpy(
        torchcore._block_sparse_pack2(torch.from_numpy(flat)))
    assert torchcore.block_sparse2_fits(nblk, nval, n_esc, L)
    back = layout.block_sparse_unpack2_host(int(nblk), int(nval), bitmap,
                                            bmask16, vals, L)
    np.testing.assert_array_equal(back, flat.astype(np.int16))


def test_block_sparse2_escape_forces_dense():
    L = 16 * 64
    flat = np.zeros(L, np.int32)
    flat[3] = 300
    nblk, nval, n_esc, *_ = _numpy(
        torchcore._block_sparse_pack2(torch.from_numpy(flat)))
    assert int(n_esc) == 1
    assert not torchcore.block_sparse2_fits(nblk, nval, n_esc, L)


def test_native_sparse_unpack_matches_python():
    if not tnative.available():
        pytest.skip("no compiler")
    rng = np.random.default_rng(17)
    L = 16 * 777 + 8                  # non-multiple-of-16 tail
    flat = _clustered(rng, L, 150, 90, 7)
    nblk, nval, n_esc, bitmap, bmask16, vals = _numpy(
        torchcore._block_sparse_pack2(torch.from_numpy(flat)))
    assert torchcore.block_sparse2_fits(nblk, nval, n_esc, L)
    want = layout.block_sparse_unpack2_host(int(nblk), int(nval), bitmap,
                                            bmask16, vals, L)
    got = tnative.block_sparse_unpack2(int(nblk), int(nval), bitmap,
                                       bmask16, vals, L)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, flat.astype(np.int16))
    assert got.dtype == np.int16
    # corrupt counts must raise, not mis-scatter
    with pytest.raises(ValueError, match="inconsistent"):
        tnative.block_sparse_unpack2(int(nblk), int(nval) + 1, bitmap,
                                     bmask16, vals, L)
    # a stray set bit after the nblk-th live block must raise too
    NB = -(-L // 16)
    bad_bitmap = bitmap.copy()
    bad_bitmap[(NB - 1) // 8] |= 0x80 >> ((NB - 1) % 8)
    with pytest.raises(ValueError, match="inconsistent"):
        tnative.block_sparse_unpack2(int(nblk), int(nval), bad_bitmap,
                                     bmask16, vals, L)


def test_pack_gop_slices_planes_matches_thunk_path():
    """pack_gop_slices_planes (serial and over a 4-thread pool) gives the
    slices of the thunks collect_wave submits, from the port's GOP
    program on the CPU."""
    w, h, n = 64, 48, 4
    frames = _make_frames(n, seed=5)
    mv8, flat = torchinter.encode_gop_planes(
        *(torch.from_numpy(np.stack([getattr(f, c) for f in frames]))
          for c in "yuv"), 27, mbw=4, mbh=3)
    intra, planes = layout.unflatten_gop(flat.numpy(), mv8.numpy(), n, 4, 3)
    sps, pps = SPS(width=w, height=h), PPS(init_qp=27)
    serial = tencoder.pack_gop_slices_planes(intra, planes, n, 4, 3, sps,
                                             pps, 27, idr_pic_id=0)
    thunks = tencoder.gop_slice_thunks_planes(intra, planes, n, 4, 3, sps,
                                              pps, 27, idr_pic_id=0)
    assert serial == [t() for t in thunks]
    with cf.ThreadPoolExecutor(4) as pool:
        pooled = tencoder.pack_gop_slices_planes(
            intra, planes, n, 4, 3, sps, pps, 27, idr_pic_id=0, pool=pool)
    assert pooled == serial
