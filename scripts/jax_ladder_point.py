"""The JAX package's ABR ladder at chip_smoke.py's ladder point.

    JAX_PLATFORMS=cpu python3 scripts/jax_ladder_point.py

Encodes bench.make_frames content (1920x1080, 16 frames, gop 8, qp 27,
rungs 1080,720,480,360 as bench.py's `_run_ladder` plans them) through
the reference's `thinvids_tpu.abr.ladder.LadderShardEncoder` on one CPU
device, and prints for every rung its size, QP, stream length and sha256,
and the sha256 of the rung's scaled planes: for each staged wave in
order, the (G, F, H', W') uint8 y, u and v stacks the scaler returned,
in C order (none for the unscaled top rung).

chip_smoke.py's ladder phase prints these beside the card's (the
LADDER_POINT_JAX there): where the card's scaled planes hash to the
same digest, the rung's stream must be the same too.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from bench import make_frames  # noqa: E402
from thinvids_tpu.abr.ladder import (LadderShardEncoder,  # noqa: E402
                                     plan_ladder, rung_segments)
from thinvids_tpu.core.config import DEFAULT_SETTINGS, Settings  # noqa: E402
from thinvids_tpu.core.types import VideoMeta, concat_segments  # noqa: E402

W, H, N, GOP, QP, RUNGS = 1920, 1080, 16, 8, 27, "1080,720,480,360"


def main() -> int:
    t0 = time.perf_counter()
    frames = make_frames(N, W, H)
    meta = VideoMeta(width=W, height=H, fps_num=30, fps_den=1, num_frames=N)
    settings = Settings(values=dict(DEFAULT_SETTINGS, qp=QP, gop_frames=GOP,
                                    ladder_rungs=RUNGS))
    rungs = plan_ladder(meta, settings)
    ladder = LadderShardEncoder(meta, rungs, gop_frames=GOP,
                                max_segments=int(settings.max_segments))
    digests = {r.name: hashlib.sha256() for r in rungs}
    for rung, scaler in zip(rungs, ladder.scalers):
        if scaler is None:
            continue

        def record(ys, us, vs, _scale=scaler.scale_wave,
                   _h=digests[rung.name]):
            out = _scale(ys, us, vs)
            for plane in out:
                _h.update(np.ascontiguousarray(np.asarray(plane)).tobytes())
            return out

        scaler.scale_wave = record
    bundles = ladder.encode(frames)
    pins = {}
    for rung, scaler in zip(rungs, ladder.scalers):
        stream = concat_segments(rung_segments(bundles, rung.name))
        planes = None if scaler is None else digests[rung.name].hexdigest()
        pins[rung.name] = [len(stream), hashlib.sha256(stream).hexdigest(),
                           planes]
        print(f"ladder rung {rung.name} {rung.width}x{rung.height} qp "
              f"{rung.qp}: {len(stream)} bytes, sha256 "
              f"{pins[rung.name][1]}, scaled planes sha256 {planes}")
    print(f"ladder point {W}x{H} x{N} gop {GOP} qp {QP} rungs {RUNGS} "
          f"({time.perf_counter() - t0:.1f} s)")
    print("LADDER_POINT_JAX = " + json.dumps(pins))
    return 0


if __name__ == "__main__":
    sys.exit(main())
