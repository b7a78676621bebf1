"""The JAX package's split-frame-encoding streams at chip_smoke.py's SFE
points.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
        python3 scripts/jax_sfe_point.py

Encodes bench.make_frames content through the reference's
`thinvids_tpu.parallel.dispatch.SfeShardEncoder` on four virtual CPU
devices, one band on each, and prints each stream's length, sha256 and
slice starts:

- the bench SFE point (bench.py's `_run_sfe` at 2160p): 3840x2160, 16
  frames, gop 8, qp 27, 4 bands, halo_rows 32, RD off;
- an RD SFE point: 1920x1080, 16 frames, gop 8, qp 25, 4 bands, halo
  32, with mode decision, the P_Skip bias and deblocking on
  (aq_strength 1.0 is asked for too; split-frame encoding strips it).

chip_smoke.py's SFE phase holds the port's card streams against the
lengths and digests this prints (SFE_POINT_JAX there). The device count
defaults to 4 when XLA_FLAGS does not set it.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4"
                               ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import make_frames  # noqa: E402
from thinvids_tpu.codecs.h264.rdo import (RdConfig,  # noqa: E402
                                          aq_from_strength)
from thinvids_tpu.core.types import VideoMeta, concat_segments  # noqa: E402
from thinvids_tpu.io.bits import slice_first_mb  # noqa: E402
from thinvids_tpu.io.mp4 import split_annexb  # noqa: E402
from thinvids_tpu.parallel.dispatch import SfeShardEncoder  # noqa: E402

#: name → (w, h, frames, gop, qp, bands, halo_rows, RdConfig)
POINTS = {
    "bench_2160p": (3840, 2160, 16, 8, 27, 4, 32, RdConfig()),
    "rd_1080p": (1920, 1080, 16, 8, 25, 4, 32,
                 RdConfig(mode_decision=True, pskip=True, deblock=True,
                          aq_q=aq_from_strength(1.0))),
}


def main(argv: list[str]) -> int:
    names = argv or list(POINTS)
    for name in names:
        w, h, n, gop, qp, bands, halo, rd = POINTS[name]
        t0 = time.perf_counter()
        frames = make_frames(n, w, h)
        meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1,
                         num_frames=n)
        enc = SfeShardEncoder(meta, qp=qp, gop_frames=gop, bands=bands,
                              halo_rows=halo, rd=rd)
        if enc.num_bands != bands:
            raise SystemExit(f"{name}: {enc.num_bands} bands on this host, "
                             f"want {bands} (set XLA_FLAGS="
                             f"--xla_force_host_platform_device_count="
                             f"{bands})")
        stream = concat_segments(enc.encode(frames))
        firsts = [slice_first_mb(u) for u in split_annexb(stream)
                  if u[0] & 0x1F in (1, 5)]
        print(f"{name} {w}x{h} x{n} gop {gop} qp {qp} bands {bands} halo "
              f"{enc.halo_rows} rd {rd}: {len(stream)} bytes, sha256 "
              f"{hashlib.sha256(stream).hexdigest()}, first_mb of frame 0's "
              f"slices {firsts[:bands]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
