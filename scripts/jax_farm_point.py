"""The JAX package's two-band split-frame stream at chip_smoke.py's farm
point.

    XLA_FLAGS=--xla_force_host_platform_device_count=2 JAX_PLATFORMS=cpu \
        python3 scripts/jax_farm_point.py

Encodes bench.make_frames content through the reference's
`thinvids_tpu.parallel.dispatch.SfeShardEncoder` on two virtual CPU
devices, one band on each (the local mesh a two-slice farm's stitched
stream must equal), and prints the stream's length, sha256 and slice
starts: bench.py's `_run_sfe` point at 2160p (3840x2160, 16 frames, gop
8, qp 27, halo_rows 32, RD off) with 2 bands (68 + 67 MB rows).

chip_smoke.py's farm phase holds the port's farm stream (two
`WorkerDaemon` slices through the coordinator's halo relay) and the
port's local two-band stream against the length and digest this prints
(FARM_POINT_JAX there). The device count defaults to 2 when XLA_FLAGS
does not set it.
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
                               + " --xla_force_host_platform_device_count=2"
                               ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import make_frames  # noqa: E402
from thinvids_tpu.core.types import VideoMeta, concat_segments  # noqa: E402
from thinvids_tpu.io.bits import slice_first_mb  # noqa: E402
from thinvids_tpu.io.mp4 import split_annexb  # noqa: E402
from thinvids_tpu.parallel.dispatch import SfeShardEncoder  # noqa: E402

#: (w, h, frames, gop, qp, bands, halo_rows)
POINT = (3840, 2160, 16, 8, 27, 2, 32)


def main() -> int:
    w, h, n, gop, qp, bands, halo = POINT
    t0 = time.perf_counter()
    frames = make_frames(n, w, h)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1,
                     num_frames=n)
    enc = SfeShardEncoder(meta, qp=qp, gop_frames=gop, bands=bands,
                          halo_rows=halo)
    if enc.num_bands != bands:
        raise SystemExit(f"{enc.num_bands} bands on this host, want {bands} "
                         f"(set XLA_FLAGS="
                         f"--xla_force_host_platform_device_count={bands})")
    stream = concat_segments(enc.encode(frames))
    firsts = [slice_first_mb(u) for u in split_annexb(stream)
              if u[0] & 0x1F in (1, 5)]
    print(f"farm_2160p {w}x{h} x{n} gop {gop} qp {qp} bands {bands} halo "
          f"{enc.halo_rows}: {len(stream)} bytes, sha256 "
          f"{hashlib.sha256(stream).hexdigest()}, first_mb of frame 0's "
          f"slices {firsts[:bands]} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
