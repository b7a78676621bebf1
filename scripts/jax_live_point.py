"""The JAX package's streams at chip_smoke.py's live points.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
        python3 scripts/jax_live_point.py

Encodes bench.make_frames content (1920x1080, 48 frames, gop 8, qp 27) on
the GOP grid a live job pins (`plan_fixed_segments(48, 8, devices)`: six
8-frame GOPs) and prints each stream's length and sha256:

- `top_1080p`: a plain GopShardEncoder on one CPU device — the live
  ladder's top rung;
- `ladder_540p`: the 540p rung of the reference's LadderShardEncoder
  (rungs "540": 1080p + 540p) on one CPU device, whose top rung must
  equal `top_1080p`;
- `sfe_1080p`: the reference's SfeShardEncoder with 4 MB-row bands, one
  on each of four virtual CPU devices (halo 32) — the split-frame live
  edge.

chip_smoke.py's live phase holds the card's live streams against these
(LIVE_POINT_JAX there). The device count defaults to 4 when XLA_FLAGS
does not set it.
"""

from __future__ import annotations

import hashlib
import json
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

import jax  # noqa: E402

from bench import make_frames  # noqa: E402
from thinvids_tpu.abr.ladder import (LadderShardEncoder,  # noqa: E402
                                     plan_ladder, rung_segments)
from thinvids_tpu.core.config import DEFAULT_SETTINGS, Settings  # noqa: E402
from thinvids_tpu.core.types import VideoMeta, concat_segments  # noqa: E402
from thinvids_tpu.parallel.dispatch import (GopShardEncoder,  # noqa: E402
                                            SfeShardEncoder, default_mesh)
from thinvids_tpu.parallel.planner import plan_fixed_segments  # noqa: E402

W, H, N, GOP, QP, BANDS = 1920, 1080, 48, 8, 27, 4


def _pin(stream: bytes) -> list:
    return [len(stream), hashlib.sha256(stream).hexdigest()]


def main() -> int:
    frames = make_frames(N, W, H)
    meta = VideoMeta(width=W, height=H, fps_num=30, fps_den=1, num_frames=N)
    one = default_mesh(jax.devices()[:1])
    pins = {}

    t0 = time.perf_counter()
    enc = GopShardEncoder(meta, qp=QP, gop_frames=GOP, mesh=one)
    enc.plan_override = plan_fixed_segments(N, GOP, enc.num_devices)
    pins["top_1080p"] = _pin(concat_segments(enc.encode(frames)))
    print(f"top_1080p: {pins['top_1080p']} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    settings = Settings(values=dict(DEFAULT_SETTINGS, qp=QP, gop_frames=GOP,
                                    ladder_rungs="540"))
    rungs = plan_ladder(meta, settings)
    ladder = LadderShardEncoder(meta, rungs, mesh=one, gop_frames=GOP)
    ladder.plan_override = plan_fixed_segments(N, GOP, ladder.num_devices)
    bundles = ladder.encode(frames)
    top = _pin(concat_segments(rung_segments(bundles, rungs[0].name)))
    if top != pins["top_1080p"]:
        raise SystemExit(f"the ladder's top rung {top} differs from the "
                         f"plain encode {pins['top_1080p']}")
    pins["ladder_540p"] = _pin(concat_segments(
        rung_segments(bundles, rungs[1].name)))
    print(f"ladder {[r.name for r in rungs]} qps {[r.qp for r in rungs]}: "
          f"540p {pins['ladder_540p']} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    del ladder, bundles

    t0 = time.perf_counter()
    sfe = SfeShardEncoder(meta, qp=QP, gop_frames=GOP, bands=BANDS,
                          halo_rows=32)
    if sfe.num_bands != BANDS:
        raise SystemExit(f"{sfe.num_bands} bands on this host, want {BANDS} "
                         f"(set XLA_FLAGS=--xla_force_host_platform_device_"
                         f"count={BANDS})")
    sfe.plan_override = plan_fixed_segments(N, GOP, sfe.num_devices)
    pins["sfe_1080p"] = _pin(concat_segments(sfe.encode(frames)))
    print(f"sfe_1080p bands {BANDS}: {pins['sfe_1080p']} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"live point {W}x{H} x{N} gop {GOP} qp {QP}")
    print("LIVE_POINT_JAX = " + json.dumps(pins))
    return 0


if __name__ == "__main__":
    sys.exit(main())
