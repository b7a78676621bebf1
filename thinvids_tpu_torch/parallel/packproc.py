"""Process-based CAVLC pack sidecars (``pack_backend=process``).

The threaded pack pool (dispatch.GopShardEncoder) scales until the
Python-side glue between native calls — view building, header packing,
thunk bookkeeping — saturates the GIL; at 4K the pack stage flatlines
even with ``pack_workers`` at all cores. This module is the other side
of the ``pack_backend=process`` escape hatch: the dispatch loop spools
one GOP's compact transfer parts (mv8 + dense hadamard-DC prefix + the
compact sparse payload) into a ``multiprocessing.shared_memory`` block
and a small process pool runs :func:`pack_gop_from_shm` — unpack +
unflatten + per-slice CAVLC pack — entirely outside the parent's GIL,
returning only the encoded slice payloads over the pool pipe.

IMPORTANT: this module must stay importable WITHOUT torch. Pool children
(spawn context) import it fresh; pulling torch in would cost each pack
worker seconds of import and, on a GPU host, could initialize a CUDA
context per child. tests/test_torch_job.py pins this. Everything needed
is numpy + the device-free codec host modules (codecs/h264/layout,
encoder, headers) + the native packer, which each child builds/loads on
first use.
"""

from __future__ import annotations

import numpy as np

from ..codecs.h264.layout import (rest_len, unflatten_gop_parts,
                                  unpack_compact_auto)


def _pack_from_buf(buf, n_mv: int, n_dense: int, nblk: int, nval: int,
                   num_frames: int, wave_frames: int, mbw: int,
                   mbh: int, sps_kw: dict, pps_kw: dict, qp: int,
                   idr_pic_id: int, rd_kw: dict | None) -> list[bytes]:
    """The actual unpack+pack over a raw buffer. Its own frame on
    purpose: every numpy view into the shared-memory buffer dies when
    it returns, so the caller's shm.close() finds no exported
    pointers."""
    from ..codecs.h264.encoder import gop_slice_thunks_planes
    from ..codecs.h264.headers import PPS, SPS
    from ..codecs.h264.rdo import RD_OFF, RdConfig

    rd = RdConfig(**rd_kw) if rd_kw else RD_OFF
    nmb = mbw * mbh
    F1 = wave_frames - 1
    arr = np.frombuffer(buf, np.uint8)
    mv8 = arr[:n_mv].view(np.int8).reshape(F1, nmb, 2)
    dense = arr[n_mv:n_mv + n_dense].view(np.int16)
    payload = arr[n_mv + n_dense:]
    Lr = rest_len(wave_frames, mbw, mbh)
    rest = unpack_compact_auto(payload, nblk, nval, Lr)
    intra, planes = unflatten_gop_parts(dense, rest, mv8,
                                        wave_frames, mbw, mbh,
                                        ships_modes=rd.ships_modes)
    thunks = gop_slice_thunks_planes(
        intra, planes, num_frames, mbw, mbh, SPS(**sps_kw),
        PPS(**pps_kw), qp, idr_pic_id=idr_pic_id, rd=rd)
    return [t() for t in thunks]


def pack_gop_from_shm(shm_name: str, n_mv: int, n_dense: int,
                      n_payload: int, nblk: int, nval: int,
                      num_frames: int, wave_frames: int, mbw: int,
                      mbh: int, sps_kw: dict, pps_kw: dict, qp: int,
                      idr_pic_id: int,
                      rd_kw: dict | None = None) -> list[bytes]:
    """Unpack + entropy-pack ONE GOP from a shared-memory spool.

    The block holds ``[mv8 | dense | compact payload]`` back to back
    (sizes in bytes; ``wave_frames`` is the wave's padded static F the
    device shapes used, ``num_frames`` the GOP's true length). Returns
    the GOP's slice payloads in slice order — identical bytes to the
    threaded path (dispatch.collect_wave), pinned by parity tests.

    The child only ATTACHES the block (close() on exit, never unlink —
    the parent owns the lifetime and unlinks after the result lands).
    """
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        return _pack_from_buf(
            memoryview(shm.buf)[:n_mv + n_dense + n_payload], n_mv,
            n_dense, nblk, nval, num_frames, wave_frames, mbw, mbh,
            sps_kw, pps_kw, qp, idr_pic_id, rd_kw)
    finally:
        try:
            shm.close()
        except BufferError:     # pragma: no cover - an exception
            # traceback pinned the views; the mapping dies with the
            # worker and the PARENT still unlinks the block, so this
            # only delays reclaim, never leaks the segment.
            pass
