"""The JAX package's two-pass VBR result at chip_smoke.py's rate-control
point.

    JAX_PLATFORMS=cpu python3 scripts/jax_rc_point.py

Encodes bench.make_frames content (1920x1080, 32 frames, gop 8, base qp
27) through the reference's `thinvids_tpu.parallel.rc.encode_vbr2pass`
at a target of 8000 kbps on one CPU device, and prints the complexity
shares, the per-GOP QPs, the number of passes, the pass-1 and final
bits, and the final stream's length and sha256.

chip_smoke.py's rc phase holds the port's card result against the
stream and QPs this prints (RC_POINT_JAX there).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import make_frames  # noqa: E402
from thinvids_tpu.core.types import VideoMeta, concat_segments  # noqa: E402
from thinvids_tpu.parallel import rc  # noqa: E402

W, H, N, GOP, BASE_QP, TARGET_KBPS = 1920, 1080, 32, 8, 27, 8000.0


def main() -> int:
    t0 = time.perf_counter()
    frames = make_frames(N, W, H)
    meta = VideoMeta(width=W, height=H, fps_num=30, fps_den=1, num_frames=N)
    segs, stats = rc.encode_vbr2pass(frames, meta, TARGET_KBPS,
                                     base_qp=BASE_QP, gop_frames=GOP)
    stream = concat_segments(segs)
    digest = hashlib.sha256(stream).hexdigest()
    print(f"rc point {W}x{H} x{N} gop {GOP} base qp {BASE_QP} target "
          f"{TARGET_KBPS} kbps: shares {stats['complexity_shares']}, "
          f"gop_qps {stats['gop_qps']}, passes {stats['passes']}, pass-1 "
          f"bits {stats['pass1_bits']}, final bits {stats['pass2_bits']}, "
          f"target bits {stats['target_bits']} "
          f"({time.perf_counter() - t0:.1f} s)")
    print("RC_POINT_JAX = " + json.dumps({
        "bytes": len(stream), "sha256": digest,
        "gop_qps": stats["gop_qps"], "passes": stats["passes"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
