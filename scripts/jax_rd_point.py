"""The JAX package's streams at bench._run_rd's rate-distortion point.

    JAX_PLATFORMS=cpu python3 scripts/jax_rd_point.py [W H N]

Encodes bench.make_frames content (default 1920x1080, 32 frames, one
closed GOP of 32, qp 25) through the reference's
`thinvids_tpu.codecs.h264.encoder.encode_gop(return_recon=True)` with
every RD feature off and with all four on (mode decision, P_Skip bias,
deblocking, aq_strength 1.0), and prints for each the stream's length
and sha256, bits/frame, PSNR-Y, SSIM-Y and the VMAF proxy, measured on
the reconstruction as bench.py measures them. chip_smoke.py's RD phase
holds the port's card streams against the lengths and digests this
prints (RD_POINT_JAX there). About two minutes and 1 GB on a CPU.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import make_frames  # noqa: E402
from thinvids_tpu.codecs.h264.encoder import encode_gop  # noqa: E402
from thinvids_tpu.codecs.h264.rdo import (RdConfig,  # noqa: E402
                                          aq_from_strength)
from thinvids_tpu.core.types import VideoMeta  # noqa: E402
from thinvids_tpu.tools.metrics import psnr, ssim, vmaf_proxy  # noqa: E402


def main(argv: list[str]) -> int:
    w, h, n = (int(a) for a in argv[:3]) if argv else (1920, 1080, 32)
    qp = 25
    frames = make_frames(n, w, h)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    configs = {
        "off": RdConfig(),
        "on": RdConfig(mode_decision=True, pskip=True, deblock=True,
                       aq_q=aq_from_strength(1.0)),
    }
    for name, rd in configs.items():
        t0 = time.perf_counter()
        stream, recons = encode_gop(frames, meta, qp=qp, idr_pic_id=0,
                                    with_headers=True, return_recon=True,
                                    rd=rd)
        ry = np.asarray(recons[0])
        ps = [psnr(f.y, ry[i][:h, :w]) for i, f in enumerate(frames)]
        ss = [ssim(f.y, ry[i][:h, :w]) for i, f in enumerate(frames)]
        p = float(np.mean([x for x in ps if np.isfinite(x)] or [99.0]))
        s = float(np.mean(ss))
        print(f"{w}x{h} x{n} qp {qp} RD {name}: {len(stream)} bytes, sha256 "
              f"{hashlib.sha256(stream).hexdigest()}, "
              f"{round(len(stream) * 8 / n)} bits/frame, PSNR-Y "
              f"{round(p, 2)} dB, SSIM-Y {round(s, 4)}, vmaf_proxy "
              f"{vmaf_proxy(p, s)} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
