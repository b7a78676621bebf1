"""The JAX package's GOP-wave stream on a two-device mesh at
chip_smoke.py's mesh point (phase 17a).

    XLA_FLAGS=--xla_force_host_platform_device_count=2 JAX_PLATFORMS=cpu \
        python3 scripts/jax_mesh_point.py

Encodes bench.make_frames content (1920x1080, 16 frames, gop 4, qp 27,
RD off) through the reference's
`thinvids_tpu.parallel.dispatch.GopShardEncoder` on a ("gop",) mesh of
two virtual CPU devices, and prints the stream's length and sha256: the
plan rounds the 4 GOPs to the mesh width and each device encodes 2 GOPs
a wave. chip_smoke.py's mesh phase holds the port's stream on a
two-entry DeviceMesh against what this prints (MESH_POINT_JAX there).
The device count defaults to 2 when XLA_FLAGS does not set it.
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

import jax  # noqa: E402
from bench import make_frames  # noqa: E402
from thinvids_tpu.core.types import VideoMeta, concat_segments  # noqa: E402
from thinvids_tpu.parallel.dispatch import (GopShardEncoder,  # noqa: E402
                                            default_mesh)

#: (w, h, frames, gop, qp, devices)
POINT = (1920, 1080, 16, 4, 27, 2)


def main() -> int:
    w, h, n, gop, qp, d = POINT
    if len(jax.devices()) < d:
        raise SystemExit(f"{len(jax.devices())} devices, want {d} (set "
                         f"XLA_FLAGS=--xla_force_host_platform_device_count"
                         f"={d})")
    t0 = time.perf_counter()
    frames = make_frames(n, w, h)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1,
                     num_frames=n)
    enc = GopShardEncoder(meta, qp=qp, gop_frames=gop,
                          mesh=default_mesh(jax.devices()[:d]))
    stream = concat_segments(enc.encode(frames))
    print(f"mesh_1080p {w}x{h} x{n} gop {gop} qp {qp} on {d} devices "
          f"({enc.plan(n).num_gops} GOPs): {len(stream)} bytes, sha256 "
          f"{hashlib.sha256(stream).hexdigest()} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
