"""Chip smoke run of the PyTorch/CUDA port (thinvids_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. device   — require CUDA; print the card (nvidia-smi name, power
              limit), torch/CUDA versions and the device count.
2. build    — build the ME kernels (nvcc, csrc/me_search.cu: the half-pel
              prepass and the search) and the host CAVLC packer (g++,
              native/cavlc_pack.cpp) concurrently, from the sources in
              this checkout; print each build's seconds and ptxas'
              registers, shared memory and spills per kernel.
3. kernels  — hold every hand-written kernel against its plain PyTorch
              version on the card, bit-exactly, at the main path's shapes
              and on small ones (MB rows that fill the search's MB strips
              partly, coinciding centres, content at the search's edge,
              qp 0 / 27 / 51, the ladder point's lower rungs at 720x1280,
              480x864 and 368x640); time each at 1088x1920 with CUDA events
              around 50 back-to-back launches (eagerly and as one CUDA
              graph), median of 5, plain versions median of 5, beside
              each kernel's bound. Then the banded launch: one launch of
              each kernel over a stack of 4 halo-extended band planes
              (B, He, W) against the plain version band by band, the
              first and last bands at the frame's edges, and its time at
              the 4K split-frame shape (4 x 608 x 3840) beside a
              single-frame launch at 2176 x 3840, with the bound over
              B He W. Then the farm slices' stacks: each slice of
              plan_bands(135, 240, 2) at 4K as a (1, 1152, 3840) stack,
              its halo toward the other slice injected as the relay
              delivers it, one launch of each kernel against the plain
              version, bit-exactly, and the second slice's stack timed as
              the banded launch is, beside its bound (phase 17d holds the
              4-band layout's runs the same way).
4. main     — the 1080p closed-GOP encode (16 frames, gop 8, qp 27)
              through GopShardEncoder(device="cuda").encode →
              concat_segments, with every kernel's launch count set to 0
              just before and read just after; check the stream's SPS and
              slice count and print its length and sha256; then the
              bench-style e2e and device-only fps, and the time of one
              GOP's parts (IDR frame, P frame and its centres / ME
              kernels / median / residual, transfer pack).
5. parity   — the same content at 352x288 (24 frames, gop 8) encoded on
              the card and on the CPU must give identical bytes.
6. job      — the transcode job path with port modules only, as the
              reference executor runs it: phase 4's clip written to a y4m
              in a temporary directory → ingest.open_video →
              make_shard_encoder(meta, Settings(defaults, gop_frames=8),
              None, device="cuda") → encode → concat_segments → mux_mp4,
              with the ME launch counts set to 0 just before and read
              just after (14 each); its Annex-B stream must equal phase
              4's; print the MP4's length and sha256 and the job's fps.
7. job parity — at 352x288 (24 frames) the job's MP4 on the card equals
              the CPU port's; the all-intra encoder (inter=False) gives
              the same bytes on the card and the CPU; compact_transfer
              off and pack_backend=process give the default stream on
              the card (the sidecars must take every GOP).
8. intra    — one 1080p all-intra wave (8 frames, every frame an IDR)
              on the card: its slices, and its fps over the wave's
              dispatch + collect (best of 2 after a warm-up).
9. rd       — the rate-distortion point of bench.py's _run_rd on the
              card: 1920x1080, 32 frames, one GOP of 32, qp 25, through
              encode_gop(return_recon=True) with RD off and with all four
              features on (mode decision, P_Skip bias, deblocking,
              aq_strength 1.0), ME launch counts set to 0 just before each
              and read just after (31 each); bits/frame, PSNR-Y, SSIM-Y
              and the VMAF proxy on the recon; each stream's length and
              sha256 must equal the JAX package's (RD_POINT_JAX, from
              scripts/jax_rd_point.py). Then GopShardEncoder(rd=RD_ALL,
              gop_frames=8) over the same frames must equal the per-GOP
              encode_gop streams; the breakdown of the RD parts (IDR
              frame per feature, P frame with the P_Skip bias and the
              filter, one timed round after a warm-up; the filter alone
              by CUDA events; a profiler count of three of them). Each
              sub-step's seconds are printed.
10. sfe     — split-frame encoding on the card. bench.py's _run_sfe
              point: 3840x2160, 16 frames, gop 8, qp 27, 4 MB-row bands
              (34 + 34 + 34 + 33 rows), halo 32, through
              SfeShardEncoder(device="cuda").encode, with the ME launch
              counts set to 0 just before and read just after (14 each:
              one launch per P frame for all bands); every picture has 4
              slices at first_mb 0, 34*240, 68*240, 102*240; the stream's
              length and sha256 equal the JAX package's (SFE_POINT_JAX,
              from scripts/jax_sfe_point.py); then _run_sfe's figures
              (fps, per-frame latency p50 / p99, bands, halo, stage_ms)
              over pre-staged waves, a warm-up GOP and the best of the
              timed passes; and a breakdown (one banded IDR step, one
              banded P step, the banded search by CUDA events). An RD
              point (1920x1080, 16 frames, gop 8, qp 25, 4 bands, mode
              decision + P_Skip bias + deblocking; AQ stripped) must give
              the JAX package's stream too.
11. rc      — two-pass VBR on the card: 1920x1080, 32 frames, gop 8, base
              qp 27, target 8000 kbps, through make_shard_encoder(...,
              device="cuda") → rc.encode_vbr2pass → concat_segments →
              mux_mp4; the ME launch counts are set to 0 before the
              analysis pass and before each encode pass and read after
              (none in the analysis, 28 each a pass); the shares, per-GOP
              QPs, passes, pass-1 and final bits and every pass's seconds;
              the stream's length and sha256 and the QPs equal the JAX
              package's (RC_POINT_JAX, from scripts/jax_rc_point.py).
12. ladder  — bench.py's _run_ladder point on the card: 1920x1080, 16
              frames, gop 8, qp 27, rungs 1080,720,480,360 through
              make_shard_encoder(rungs=plan_ladder(...), device="cuda"),
              with the ME launch counts set to 0 just before and read just
              after (4 x 14 each); the top rung equals phase 4's stream and
              h2d_bytes phase 4's upload; every scaled plane is within 1
              LSB of scale_plane_np on the same padded source; each lower
              rung equals a GopShardEncoder run over the ladder's own
              planes; each rung's stream and planes beside the JAX
              package's (LADDER_POINT_JAX, from
              scripts/jax_ladder_point.py: where the planes hash alike the
              streams must be equal); the scaler refuses TF32; bench's
              figures (fps through encode() in a second pass without the
              plane recording, aggregate fps over pre-staged waves,
              bits/frame per rung, stage_ms.scale); and a ladder job with
              port modules only (y4m → open_video → plan_ladder →
              make_shard_encoder(rungs=) → encode → rung_segments →
              hls.package_ladder → lint_ladder).
13. live    — bench.py's two _run_live points through the port's
              cluster.executor.run_live(device="cuda"), 1920x1080, 48
              frames of the bench content, gop 8, qp 27: a paced writer
              thread appends y4m frames to a growing `.live.y4m` in a
              temporary directory (closing it with `.eos`), run_live tails
              it on a thread, and bench's edge sampler reads the top
              rung's media playlist (one glass-to-playlist sample per
              announced part). Each leg first runs bench's pace probe
              (the port's batch ladder over the whole clip on the pinned
              GOP grid, then one GOP twice): ingest at half the 1-GOP edge
              rate (at most 30 fps), segment_s provisioned to at least two
              GOP-walls. The ladder leg (ladder_rungs "540": 1080p + 540p,
              dvr_window_s 2, live_stall_s 10): the live warm-up launches
              each ME kernel 2 x 7 times and the live run 84 times (ME
              launch counts set to 0 just before each, read just after);
              the top rung equals the JAX package's stream
              (LIVE_POINT_JAX, from scripts/jax_live_point.py) and the
              probe's batch ladder, the 540p rung equals the batch
              ladder's (and is printed beside JAX's); the closed tree
              passes lint_ladder (or the live lint on every rung after DVR
              garbage collection). The split-frame leg (ladder_rungs
              "1080", sfe_bands 4, ingest at 0.8 x its probe): 7 warm-up
              and 42 live launches of each kernel, 4 slices a picture, the
              JAX package's 4-band stream. Each leg prints one JSON line:
              latency p50 / p99, ingest fps, provisioned segment_s, DVR
              segments, GOPs, the stage_snapshot() delta, for split-frame
              frame_latency_percentiles(), and its seconds.
14. manager — the port's manager node as an operator starts it, in a
              subprocess on the card: `python -m thinvids_tpu_torch.cli
              coordinator --device cuda` (watch folder, library, state
              dir, scan interval 0.5 s; TVT_MIN_IDLE_WORKERS=0, phase 6's
              gop 8 and qp 27, a TVT_PROFILE_DIR). Phase 6's 1080p
              16-frame y4m dropped into the watch folder becomes a job
              whose library MP4 must equal phase 6's, byte for byte; the
              job's torch.profiler trace must hold 14 launches of each ME
              kernel. The same clip posted to /add_job without the
              profiler must give the same MP4 (its job fps is printed).
              A ladder job posted to /add_job (phase 12's rungs,
              not profiled) must write phase 12's ladder job tree, file
              for file, and the origin must serve its master playlist at
              /hls/<job>/master.m3u8. /metrics_snapshot must show the
              node row with 1 device of this card's name and its memory
              total, and a non-empty stage_ms. It prints the daemon's
              start-up seconds and each job's wall time from submit to
              done, beside the card's name and power limit; the daemon
              is stopped in any case.
16. farm    — the remote backend and the farm on the card, before phase
              15: `python -m thinvids_tpu_torch.cli coordinator --backend
              remote --device cuda` (watch folder, library, state dir;
              TVT_REMOTE_SHARD_GOPS=1, gop 8, qp 27, a 3 s heartbeat
              TTL) and two `cli worker --device cuda` processes. Phase
              6's 1080p y4m dropped into the watch folder becomes a job
              of two 1-GOP shards whose MP4 must equal phase 6's, each
              worker having done at least one shard. The worker
              processes then stop, and two WorkerDaemon(device="cuda")
              threads of this process (each with its node agent) take
              their place, so the kernels' launch counts see them: a
              4K farm SFE job (bench.py's _run_sfe point, 16 frames,
              gop 8, qp 27, halo 32, sfe_bands 2: one band a worker,
              the halo relay over the daemon's /work/halo) posted to
              /add_job, with the ME launch counts set to 0 just before
              and read just after (28 each: every worker once per P
              frame for its slice, no dense replay). Its MP4 must equal
              the MP4 of the local SfeShardEncoder(bands=2) stream of
              the same frames on the card, and that stream the JAX
              package's (FARM_POINT_JAX, from scripts/jax_farm_point.py).
              It prints the daemon's and the workers' start-up, each
              job's submit to done and run, the farm's fps, the
              workers' stage_ms (halo, dispatch, ...) and the per-frame
              latency p50 / p99, beside the card's name and power
              limit; every process it starts is stopped in any case.
17. mesh    — the device mesh (core.devices.DeviceMesh), after phase 16:
              every card when the machine has two or more, else two
              entries on cuda:0 (printed as "mesh: D entries on N
              distinct cards"; an aliased run is no multi-card
              measurement and says so). (c) Both ME kernels on a mesh
              entry's run at the 4K split-frame point: two 608-row bands
              a (2, 608, 3840) stack, the other run's rows injected, one
              launch each on every entry's card against the plain
              version, bit-exactly, and the first run's time beside its
              bound. (a) bench's 1080p content, 16 frames, gop 4, qp 27
              through GopShardEncoder(mesh=): the stream must equal the
              JAX package's on two devices (MESH_POINT_JAX, from
              scripts/jax_mesh_point.py) and each kernel's per-card
              launch count (torchme's {card index: launches} maps, set
              to 0 just before) the P frames of the entries on that card
              (12 in all, 6 an entry on two entries); e2e fps over
              pre-staged waves beside the same point on one entry and
              phase 4's. (b) bench's 4K split-frame point with its 4
              bands spread over the mesh: the stream must equal phase
              10's, each kernel launched once per P frame per entry (28
              on two entries); fps, the IDR step's seconds and the
              per-frame latency p50 / p99 beside phase 10's. (d) The farm
              on meshes: bench's 4K split-frame point as a farm SFE job
              with sfe_bands 4 through a remote coordinator daemon (as
              phase 16 starts it), taken by two in-process WorkerDaemon
              threads, each on a two-entry mesh (cuda:0,1 and cuda:2,3 on
              four cards, else cuda:0 twice each: aliased, the path, not
              a measurement): one 2-band slice a worker, one band a run.
              First both kernels at those runs' (1, 608, 3840) stacks,
              each on its run's card, the other slice's rows injected and
              the own slice's other run's copied card to card: one launch
              each a run, bit-exactly against the plain version, band
              1's time beside its bound. The job's MP4 must be the mux of
              (b)'s stream (SFE_POINT_JAX), each kernel launched once per
              P frame per entry, counted by card (14 each on 4 distinct
              cards, 56 on an aliased cuda:0); its fps, the workers'
              stage_ms and the per-frame gap p50 / p99 beside phase 16's
              2-band farm. Every figure names the mesh and the card.
15. card = CPU — after every timed section, the 352x288 card == CPU
              checks of phases 9, 10 and 12, the CPU port's side of
              phases 9 and 10 in two worker processes (spawned, CPU only)
              while the card runs its side. Phase 9's: the card's bytes
              and recon equal the CPU's for every RD config the CPU tests
              use, the all-intra wave with mode decision + AQ, and the
              process pack with every feature on. Phase 10's: bytes and
              recon for 1, 3 and 4 bands, the escape content that reruns
              dense and the RD features, and at 352x96 for 6 one-MB-row
              bands (halo clamped to 16); bands=1 equals the
              GopShardEncoder stream. Phase 12's: at rungs 240, 144 the
              CPU port's rung encoders, fed the card's scaled planes,
              give the card's rung bytes.

18. check   — after phase 15. (a) `python -m thinvids_tpu_torch.cli
              check --json` in a subprocess under `-X importtime`: it
              must exit 0 with no open finding and no stale waiver, and
              import neither torch nor jax; prints the module count and
              the waived keys. (b) The runtime counterpart of TVT-S001 /
              X002: phase 4's main path (1080p, 16 frames, gop 8, qp 27,
              the ME launch counts set to 0 just before and read just
              after: 14 each) and one all-intra IDR frame run under
              torch.cuda.set_sync_debug_mode("warn"), then one IDR
              frame's and one P frame's device step alone; every
              warning's innermost thinvids_tpu_torch frame is taken from
              a warnings.showwarning hook (traceback.extract_stack()),
              and the syncs are printed per module:function for each
              run. It fails if a site lies outside the manifest's
              sync_allowlist and no S001/S002 waiver names its module,
              or lies in a declared hot loop; it also prints whether the
              debug mode reports an explicit torch.cuda.synchronize()
              and Event.synchronize(). (c) encode_waves(...,
              pack_workers=1) and pack_workers=8 give phase 4's stream.
19. spec    — after phase 18, no ME kernel (the launch counts set to 0
              just before must read 0 just after): the card's intra
              program against the numpy specification
              (codecs.h264.encoder.encode_frame_arrays). Bench content
              at 352x288, qp 27, for RD off, mode decision, AQ and both:
              torchcore.encode_intra's levels and _intra_core's recon,
              fetched, must equal the spec's; then one 1080p RD-off IDR
              frame the same way; each side's seconds are printed. Then
              DeviceMesh([cuda:0] * 8): encode_clip_sharded's all-intra
              stream of 16 iid-noise frames at 64x48 (gop 2, qp 27)
              must equal H264Encoder(use_device=False)'s frames in the
              8-wide GOP plan, SPS/PPS at each GOP head.

Before the last line it prints one JSON object of kernel records and the
card's name and power limit; the last line is the device JSON object.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from thinvids_tpu_torch import native
from thinvids_tpu_torch.codecs.h264 import headers, torchme
from thinvids_tpu_torch.codecs.h264.rdo import (RD_OFF, RdConfig,
                                                aq_from_strength)
from thinvids_tpu_torch.core.types import Frame, VideoMeta, concat_segments
from thinvids_tpu_torch.io.bits import split_annexb
from thinvids_tpu_torch.parallel.dispatch import GopShardEncoder

#: int32 lane-operation rate of one H100 SXM: 132 SMs x 64 INT32 lanes x
#: 1.98 GHz boost (NVIDIA Hopper architecture white paper), at the
#: card's full 700 W power limit; an upper limit on any per-lane
#: integer instruction, VABSDIFF4 included
H100_INT32_OPS = 132 * 64 * 1.98e9
#: HBM3 bandwidth of one H100 SXM (NVIDIA data sheet)
H100_BYTES_PER_S = 3.35e12
#: the ME kernel's time at 1088x1920 `pan` content before its redesign
#: (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W)
ME_SEARCH_PREV_MS = 0.6304
#: every RD feature on, at bench.py's strength (the _run_rd "on" point)
RD_ALL = RdConfig(mode_decision=True, pskip=True, deblock=True,
                  aq_q=aq_from_strength(1.0))
#: the JAX package's streams at the RD point (1920x1080, 32 frames, one
#: GOP, qp 25, bench content): (length, sha256), as
#: `JAX_PLATFORMS=cpu python3 scripts/jax_rd_point.py` prints them
RD_POINT_JAX = {
    "off": (821211, "a6d865e0cabe1e39046986304bcbd197"
                    "249bf287f1680b3db02b85d15e29ea8b"),
    "on": (737477, "8ff2d64ebc62b36e7b2b37741cf3162e"
                   "869d589cc241577bcea800fd14f59f3b"),
}
#: the JAX package's split-frame streams (length, sha256): bench.py's
#: _run_sfe point (3840x2160, 16 frames, gop 8, qp 27, 4 bands, halo 32)
#: and an RD point (1920x1080, 16 frames, gop 8, qp 25, 4 bands, halo 32,
#: mode decision + P_Skip bias + deblocking), as
#: `XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu
#: python3 scripts/jax_sfe_point.py` prints them
SFE_POINT_JAX = {
    "bench_2160p": (3221421, "2b7fe930ccc0c214c611bb6a8af29add"
                             "b2fc3ab9a75b6f84fd55ced1ab6e0512"),
    "rd_1080p": (1034887, "05a4171023492cd939e1ed14cd9ddf77"
                          "15776fa44e935345013d0cfb10c8d118"),
}
#: the JAX package's 2-band split-frame stream at the farm point
#: (bench.py's _run_sfe point with 2 bands: 3840x2160, 16 frames, gop 8,
#: qp 27, halo 32): (length, sha256), as
#: `XLA_FLAGS=--xla_force_host_platform_device_count=2 JAX_PLATFORMS=cpu
#: python3 scripts/jax_farm_point.py` prints it
FARM_POINT_JAX = (3221387, "ba283c3805c0cc930af0a67d9e52d138"
                            "7c7ff07fe4b1ceba2e2daff25f7d22d1")
#: the JAX package's GOP-wave stream on a two-device mesh at the mesh
#: point (bench content, 1920x1080, 16 frames, gop 4, qp 27, RD off):
#: (length, sha256), as `XLA_FLAGS=--xla_force_host_platform_device_count=2
#: JAX_PLATFORMS=cpu python3 scripts/jax_mesh_point.py` prints it
MESH_POINT_JAX = (1580071, "a0eede0d15023e8689d2faa5a670972a"
                           "555bec4ca2aa510b7981704ff8218e72")
#: the JAX package's two-pass VBR result at the rc point (1920x1080, 32
#: frames, gop 8, base qp 27, 8000 kbps, bench content), as
#: `JAX_PLATFORMS=cpu python3 scripts/jax_rc_point.py` prints it
RC_POINT_JAX = {"bytes": 1015895,
                "sha256": "f0106f962a6a647791843dc5749fa4de"
                          "d1c2263af222c9cd24b841ba684fb246",
                "gop_qps": [33, 33, 33, 33], "passes": 4}
#: the JAX package's ladder at bench.py's _run_ladder point (1920x1080, 16
#: frames, gop 8, qp 27, rungs 1080,720,480,360): rung → (length, sha256,
#: sha256 of the rung's scaled y, u, v wave stacks; None for the top
#: rung), as `JAX_PLATFORMS=cpu python3 scripts/jax_ladder_point.py`
#: prints them
LADDER_POINT_JAX = {
    "1080p": (856516, "1e1ae9ce6e4cc11a6bb20993345f779e"
                      "b39edb78987907913e02d77d534b59ee", None),
    "720p": (219434, "fa3691133c90ac6a033cdd09eb42d155"
                     "0cbf745ec757c533716e078d5d0510bc",
             "2a0ec853739df6f6338e9fb16e4ae561"
             "51dc4256fb8c64649c93b1b0eb7fa8f1"),
    "480p": (144427, "bfabae809c7c3bc71adb8d0edf8ceed9"
                     "84f86dedb7a39c8160139247a6508f30",
             "22a02da14abecff7231214b397893850"
             "48b6673115bddf51f511fdc02ef290fe"),
    "360p": (84370, "9f1005563570a2e16abdb6efe54293ac"
                    "bfaf7bae2a82129888d25fd0efbd6fb8",
             "a3e0d99dacebc4663a9f636d5b1e7681"
             "6dfa2d55f3fe7efdb4e9e079711c26d4"),
}
#: the JAX package's streams at the live point (1920x1080, 48 frames, gop 8,
#: qp 27, bench content, on the live GOP grid): the top rung (a plain
#: encode), the ladder's 540p rung and the 4-band split-frame stream, as
#: (length, sha256), as `XLA_FLAGS=--xla_force_host_platform_device_count=4
#: JAX_PLATFORMS=cpu python3 scripts/jax_live_point.py` prints them
LIVE_POINT_JAX = {
    "top_1080p": (2566875, "9c088903fd51d0e98c2b471c8302d752"
                           "832bffbd271ccf04dd622e63cb9b34c9"),
    "ladder_540p": (454528, "ecce99cbcc38dd43960e619b9efecdc6"
                            "0b88166bd35adc6a0bfb50fade6476a5"),
    "sfe_1080p": (2566646, "f9c24dc1ca8422500e7261f8518a8796"
                           "e78682defa178cf6f3d609288afbede1"),
}
#: the RD configs the CPU parity tests hold against the JAX package
RD_TEST_CONFIGS = {
    "md": RdConfig(mode_decision=True),
    "aq4": RdConfig(aq_q=4),
    "md_aq6": RdConfig(mode_decision=True, aq_q=6),
    "aq12": RdConfig(aq_q=12),
    "pskip_deblock": RdConfig(pskip=True, deblock=True),
    "md_aq4": RdConfig(mode_decision=True, aq_q=4),
    "all": RD_ALL,
    "pskip": RdConfig(pskip=True),
    "deblock": RdConfig(deblock=True),
}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def make_frames(n: int, w: int, h: int, seed: int = 0, pan: int = 3):
    """Synthetic video-like content: a camera pan over a fixed detailed
    scene (gradient + texture + static grain), `pan` px/frame diagonal
    (the repository benchmark's content)."""
    rng = np.random.default_rng(seed)
    pad = pan * n + 2
    yy, xx = np.mgrid[0:h + pad, 0:w + pad]
    scene = (xx * 0.1 + yy * 0.05) % 256 \
        + 24.0 * np.sin(xx * 0.07) * np.cos(yy * 0.05) \
        + rng.normal(0, 6.0, (h + pad, w + pad))
    scene = np.clip(scene, 0, 255).astype(np.uint8)
    scene_u = np.clip(128 + 30 * np.sin(xx[::2, ::2] * 0.01),
                      0, 255).astype(np.uint8)
    scene_v = np.clip(128 + 30 * np.cos(yy[::2, ::2] * 0.01),
                      0, 255).astype(np.uint8)
    frames = []
    for i in range(n):
        dy = dx = pan * i
        frames.append(Frame(
            y=scene[dy:dy + h, dx:dx + w],
            u=scene_u[dy // 2:dy // 2 + h // 2, dx // 2:dx // 2 + w // 2],
            v=scene_v[dy // 2:dy // 2 + h // 2, dx // 2:dx // 2 + w // 2],
        ))
    return frames


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ---- phase 2 -----------------------------------------------------------

def build_all() -> None:
    """Build both native libraries concurrently, one compiler each."""
    results: dict = {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            results[name] = (time.perf_counter() - t0, None)
        except Exception as exc:  # noqa: BLE001 - re-raised below
            results[name] = (time.perf_counter() - t0, exc)

    threads = [threading.Thread(target=run, args=a) for a in (
        ("me_search (nvcc)", torchme.load_me_library),
        ("cavlc_pack (g++)", native._build_and_load))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, (sec, exc) in results.items():
        print(f"build {name}: {sec:.2f} s", flush=True)
        if exc is not None:
            raise RuntimeError(f"build {name} failed") from exc
    if torchme.BUILD_INFO is not None:
        for line in torchme.BUILD_INFO[1].splitlines():
            if any(s in line for s in ("entry function", "registers",
                                        "smem", "spill")):
                print(f"  ptxas: {line.strip()}")
    sass_summary()


def sass_summary() -> None:
    """Which instruction the search's packed SAD became: count each
    kernel's VABSDIFF4 in cuobjdump's SASS and require 64 in the search
    (16 rows x 4 words of one candidate, each one `__vsadu4`)."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = f"{CUDA_HOME}/bin/cuobjdump" if CUDA_HOME else "cuobjdump"
    sass = subprocess.run([tool, "-sass", torchme._ME_SO],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        n = sum(1 for line in body.splitlines()
                if line.lstrip().startswith("/*") and ";" in line)
        counts[name.strip()] = body.count("VABSDIFF4")
        print(f"sass {name.strip()}: {n} instructions, "
              f"{counts[name.strip()]} VABSDIFF4", flush=True)
    search = [c for name, c in counts.items() if "search_kernel" in name]
    check(search == [64], f"search_kernel's SASS holds {search} VABSDIFF4, "
                          "want one kernel with 64")


# ---- phase 3 -----------------------------------------------------------

def _me_inputs(kind: str, h: int, w: int, seed: int):
    """(cur, ref_y, ref_u, ref_v) uint8 planes of one content kind."""
    rng = np.random.default_rng(seed)
    pad = 40
    if kind == "noise":
        cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
        ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    else:
        scene = rng.integers(0, 255, (h + 2 * pad, w + 2 * pad)).astype(
            np.uint8)
        if kind == "pan":
            scene = ((np.mgrid[0:h + 2 * pad, 0:w + 2 * pad][1] * 3) % 256
                     + scene // 8).astype(np.uint8)
        ref = scene[pad:pad + h, pad:pad + w]
        cur = np.empty_like(ref)
        # (dy, dx) of the left and right halves' true motion
        (ly, lx), (ry_, rx) = {
            "mixed": ((3, 3), (-2, 1)),
            "pan": ((5, -7), (5, -7)),
            "range": ((15, -14), (-13, 16)),   # hits the search range
        }[kind]
        cur[:, :w // 2] = scene[pad + ly:pad + ly + h,
                                pad + lx:pad + lx + w // 2]
        cur[:, w // 2:] = scene[pad + ry_:pad + ry_ + h,
                                pad + w // 2 + rx:pad + w + rx]
    ref_u = rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
    ref_v = rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
    return cur, ref, ref_u, ref_v


def _median_ms(fn, reps: int = 5) -> float:
    """Median ms of one call, an event pair around each (for the plain
    versions, which take tens of ms)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _loop_ms(fn, n: int = 50, reps: int = 5) -> float:
    """ms of one call of `fn`: one event pair around `n` calls enqueued
    back to back, divided by `n`, median of `reps`. L2 is warm, as on
    the main path, where the reference was just written."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def _graph_ms(fn, n: int = 50, reps: int = 5) -> float:
    """As _loop_ms, with the `n` calls captured once into a CUDA graph
    and the graph replayed: the host's cost per call drops out, so this
    is the device's time for back-to-back launches."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    ms = _loop_ms(g.replay, n=1, reps=reps) / n
    del g
    return ms


def me_bounds(h: int, w: int, b: int = 1) -> dict:
    """(operations, bytes) each ME kernel must do and move at h x w, or
    over a stack of b planes of h x w (a banded launch: every band is a
    plane with its own margin). Operations are counted in the
    instruction the kernel uses: one VABSDIFF4 takes four pixel
    differences and their sum, so the search needs 227 h w / 4; the
    prepass one multiply-add per tap of its three 6-tap filters (b, h,
    and j over b's unrounded sums) per plane sample. Bytes: each input
    read once, each output written once."""
    hp, wp = h + 2 * torchme.ME_HALO, w + 2 * torchme.ME_HALO
    planes = 4 * hp * wp
    chroma = 2 * (h // 2) * (w // 2) * 2
    # cur, chroma refs in; mv, pred_y, pred_u, pred_v out (per plane)
    rest = (h * w * 2 + chroma + (h // 16) * (w // 16) * 2 * 4 + h * w * 2
            + chroma)
    shared = 3 * 2 * 4 + 4             # centres and lam, read once
    pre_ops = 3 * 6 * hp * wp
    search_ops = len(torchme.OFFSET_TABLE) * h * w // 4
    return {
        "me_halfpel": (b * pre_ops, b * (h * w * 2 + planes)),
        "me_search": (b * search_ops, b * (planes + rest) + shared),
        # both kernels as one function: the planes stay inside it
        "me_total": (b * (pre_ops + search_ops),
                     b * (h * w * 2 + rest) + shared),
    }


def _bound(ops: int, nbytes: int) -> tuple[float, str]:
    t_ops = ops / H100_INT32_OPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def check_me_kernels(dev) -> list[dict]:
    """The prepass against halfpel_planes_ref and me_search_cuda against
    me_search_ref on the card, bit-exact; then their times at 1080p."""
    cases = []
    # 80 and 176 columns are 5 and 11 MBs: strips of 4 MBs run past them;
    # 720x1280, 480x864 (54 MBs) and 368x640 are the ladder's lower rungs
    for (h, w) in [(48, 64), (48, 80), (128, 192), (144, 176), (1088, 1920),
                   (720, 1280), (480, 864), (368, 640)]:
        for i, kind in enumerate(("mixed", "pan", "noise", "range")):
            cases.append((kind, h, w, i, None, 27))
    # coinciding centres: probe = median = zero
    cases.append(("noise", 128, 192, 7, "zero", 27))
    cases.append(("mixed", 1088, 1920, 8, "zero", 27))
    for qp in (0, 51):
        for (h, w) in [(48, 80), (144, 176), (1088, 1920)]:
            cases.append(("mixed", h, w, 9 + qp, None, qp))
        cases.append(("pan", 144, 176, 11, "zero", qp))
    err_planes = err_me = 0
    for kind, h, w, seed, cent, qp in cases:
        cur, ref, ru, rv = (torch.from_numpy(a.astype(np.int16)).to(dev)
                            for a in _me_inputs(kind, h, w, seed))
        pmv = torch.tensor([5, -9], dtype=torch.int32, device=dev)
        if cent == "zero":
            centers = torch.zeros((3, 2), dtype=torch.int32, device=dev)
        else:
            centers = torchme.centers_from(cur, ref, pmv)
        lam = torchme.lambda_for(qp, dev)
        planes = torchme.halfpel_planes_cuda(ref)
        got = torchme.me_search_cuda(cur, ref, ru, rv, centers, lam)
        torch.cuda.synchronize()
        err = int((planes.to(torch.int32) - torchme.halfpel_planes_ref(ref)
                   .to(torch.int32)).abs().max())
        err_planes = max(err_planes, err)
        check(err == 0, f"halfpel planes {kind} {h}x{w}: differ (max "
                        f"|diff| {err})")
        want = torchme.me_search_ref(cur, ref, ru, rv, centers, lam)
        for name, a, b in zip(("mv", "pred_y", "pred_u", "pred_v"),
                              got, want):
            err = int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
            err_me = max(err_me, err)
            check(err == 0, f"me_search {kind} {h}x{w} {cent} qp {qp}: "
                            f"{name} differs (max |diff| {err})")
        nmv = len({tuple(v) for v in got[0].reshape(-1, 2).tolist()})
        print(f"me_search {kind:5s} {h}x{w} qp {qp} centres="
              f"{centers.tolist()}: planes and outputs bit-exact ({nmv} "
              "distinct MVs)", flush=True)

    # timing at the main path's shape, kernels in turns
    h, w = 1088, 1920
    cur, ref, ru, rv = (torch.from_numpy(a.astype(np.int16)).to(dev)
                        for a in _me_inputs("pan", h, w, 3))
    centers = torchme.centers_from(
        cur, ref, torch.zeros(2, dtype=torch.int32, device=dev))
    lam = torchme.lambda_for(27, dev)
    planes = torchme.halfpel_planes_cuda(ref)
    fns = {
        "me_halfpel": lambda: torchme.halfpel_planes_cuda(ref),
        "me_search": lambda: torchme.me_search_planes_cuda(
            cur, planes, ru, rv, centers, lam),
        "me_total": lambda: torchme.me_search_cuda(cur, ref, ru, rv,
                                                   centers, lam),
    }
    eager = {k: [] for k in fns}
    graph = {k: [] for k in fns}
    for _ in range(2):
        for k, fn in fns.items():
            eager[k].append(_loop_ms(fn))
            graph[k].append(_graph_ms(fn))
    plain = {"me_halfpel": _median_ms(lambda: torchme.halfpel_planes_ref(ref)),
             "me_search": _median_ms(lambda: torchme.me_search_ref(
                 cur, ref, ru, rv, centers, lam))}
    bounds = me_bounds(h, w)
    recs = []
    for name, (ops, nbytes) in bounds.items():
        bound_ms, bound_by = _bound(ops, nbytes)
        ms = min(graph[name])
        print(f"{name} 1088x1920: {ms:.4f} ms a launch (CUDA graph of 50, "
              f"median of 5; runs {graph[name]}), eager loop of 50 "
              f"{eager[name]} ms, plain {plain.get(name, 'n/a')} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({ops / 1e6:.1f} M ops, "
              f"{nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f}% of bound",
              flush=True)
        if name == "me_total":
            continue
        recs.append({
            "name": name, "route": "cuda",
            "source": "thinvids_tpu_torch/csrc/me_search.cu",
            "replaces": "thinvids_tpu/codecs/h264/jaxme.py:265",
            "launches": None,
            "max_abs_err": err_planes if name == "me_halfpel" else err_me,
            "ms": ms, "eager_ms": min(eager[name]),
            "plain_ms": plain[name], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    print(f"ME before the redesign (one kernel; recorded in PERF.md, not "
          f"measured in this run): {ME_SEARCH_PREV_MS} ms")
    return recs


def _band_stacks(cur, ref, ru, rv, bands: int, halo: int):
    """A frame's planes as split-frame encoding hands them to the
    kernels: (B, Hb + 2 halo, W) stacks of halo-extended bands
    (torchme.extend_bands of the frame cut into `bands` bands)."""
    return torchme.extend_bands(
        *(p.reshape(bands, p.shape[0] // bands, p.shape[1])
          for p in (cur, ref, ru, rv)), halo)


def check_banded_me_kernels(dev) -> dict:
    """One launch of each kernel over a B = 4 stack of halo-extended band
    planes against the plain version band by band (halfpel_planes_ref and
    me_search_ref loop over the bands), bit-exactly; the first and last
    bands sit at the frame's edges. Then the banded launch's time at the
    4K split-frame shape (4 x 608 x 3840: 34-MB-row bands, halo 32)
    beside one single-frame launch at 2176 x 3840, with the bound over
    B He W."""
    cases = [("mixed", 128, 80, 4, 16, 1), ("range", 256, 192, 4, 32, 2),
             ("noise", 128, 176, 4, 32, 3), ("pan", 2176, 3840, 4, 32, 4)]
    err_planes = err_me = 0
    for kind, h, w, bands, halo, seed in cases:
        cur, ref, ru, rv = (torch.from_numpy(a.astype(np.int16)).to(dev)
                            for a in _me_inputs(kind, h, w, seed))
        cur_s, ref_s, ru_s, rv_s = _band_stacks(cur, ref, ru, rv, bands,
                                                halo)
        Hb = h // bands
        centers = torchme.banded_centers_from(
            cur.reshape(bands, Hb, w), ref.reshape(bands, Hb, w),
            torch.tensor([5, -9], dtype=torch.int32, device=dev),
            (Hb,) * bands, halo)
        lam = torchme.lambda_for(27, dev)
        planes = torchme.halfpel_planes_cuda(ref_s)
        got = torchme.me_search_cuda(cur_s, ref_s, ru_s, rv_s, centers, lam)
        torch.cuda.synchronize()
        want_planes = torchme.halfpel_planes_ref(ref_s)
        err = int((planes.to(torch.int32) - want_planes.to(torch.int32))
                  .abs().max())
        err_planes = max(err_planes, err)
        check(err == 0, f"banded halfpel planes {kind} {bands}x{h}x{w}: "
                        f"differ (max |diff| {err})")
        want = torchme.me_search_ref(cur_s, ref_s, ru_s, rv_s, centers, lam)
        for name, a, b in zip(("mv", "pred_y", "pred_u", "pred_v"),
                              got, want):
            check(a.shape == b.shape and a.shape[0] == bands,
                  f"banded {name}: shape {tuple(a.shape)} vs "
                  f"{tuple(b.shape)}")
            err = int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
            err_me = max(err_me, err)
            check(err == 0, f"banded me_search {kind} {bands}x{h}x{w} halo "
                            f"{halo}: {name} differs (max |diff| {err})")
        print(f"banded me_search {kind:5s} {bands} bands of "
              f"{tuple(cur_s.shape[1:])} (frame {h}x{w}, halo {halo}) "
              f"centres={centers.tolist()}: one launch each, planes and "
              "outputs bit-exact against the per-band plain version",
              flush=True)

    # timing at the 4K split-frame shape: the stack of the last case
    B, He, W = cur_s.shape
    planes_s = torchme.halfpel_planes_cuda(ref_s)
    planes_f = torchme.halfpel_planes_cuda(ref)
    fns = {
        "me_halfpel": (lambda: torchme.halfpel_planes_cuda(ref_s),
                       lambda: torchme.halfpel_planes_cuda(ref)),
        "me_search": (lambda: torchme.me_search_planes_cuda(
            cur_s, planes_s, ru_s, rv_s, centers, lam),
            lambda: torchme.me_search_planes_cuda(
                cur, planes_f, ru, rv, centers, lam)),
    }
    graph = {k: ([], []) for k in fns}
    eager = {k: [] for k in fns}
    for _ in range(2):
        for k, (banded, frame) in fns.items():
            graph[k][0].append(_graph_ms(banded))
            graph[k][1].append(_graph_ms(frame))
            eager[k].append(_loop_ms(banded))
    plain = {"me_halfpel": _median_ms(
        lambda: torchme.halfpel_planes_ref(ref_s), reps=3),
        "me_search": _median_ms(lambda: torchme.me_search_ref(
            cur_s, ref_s, ru_s, rv_s, centers, lam), reps=3)}
    bounds = me_bounds(He, W, B)
    out = {}
    for name in fns:
        ops, nbytes = bounds[name]
        bound_ms, bound_by = _bound(ops, nbytes)
        ms = min(graph[name][0])
        print(f"{name} banded {B}x{He}x{W}: {ms:.4f} ms a launch (CUDA graph "
              f"of 50, median of 5; runs {graph[name][0]}), eager loop of 50 "
              f"{eager[name]} ms; single frame {h}x{w}: "
              f"{min(graph[name][1]):.4f} ms; plain (band loop) "
              f"{plain[name]:.3f} ms; bound {bound_ms:.4f} ms by {bound_by} "
              f"({ops / 1e6:.1f} M ops, {nbytes / 1e6:.2f} MB), "
              f"{100 * bound_ms / ms:.1f}% of bound", flush=True)
        out[name] = {"shape": [B, He, W], "launches": None,
                     "max_abs_err": (err_planes if name == "me_halfpel"
                                     else err_me),
                     "ms": ms, "eager_ms": min(eager[name]),
                     "frame_ms": min(graph[name][1]),
                     "frame_shape": [h, w], "plain_ms": plain[name],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None}
    return out


def check_farm_slice_kernels(devs, groups=((0, 1), (1, 2))) -> dict:
    """Both kernels on the stacks a farm's slices hand them, one band a
    run: each band b of plan_bands(135, 240, B) at 4K (B = the bands the
    slices `groups` cover) as a (1, Hb + 2 x 32, 3840) stack on card
    devs[b]. Its halo toward another slice is that slice's rows injected
    as the relay delivers them (uploaded from the host); toward a run of
    its own slice, the neighbouring run's rows copied from that run's
    card (torchme.extend_bands with `ext`; the frame's edges
    replicated). One launch each against the plain version,
    bit-exactly; then band 1's stack timed as the banded launch is,
    beside its bound. Each record carries the check's launches by card
    index."""
    from thinvids_tpu_torch.parallel.planner import plan_bands

    bands = groups[-1][1]
    Hb = plan_bands(135, 240, bands).band_mb_rows * 16
    h, w, halo = bands * Hb, 3840, 32
    host = [torch.from_numpy(a.astype(np.int16))
            for a in _me_inputs("pan", h, w, 5)]        # cur, ref, ru, rv
    div = (1, 1, 2, 2)
    slice_of = {b: g for g in groups for b in range(*g)}
    parts = [[p[b * Hb // d:(b + 1) * Hb // d].to(devs[b])
              for p, d in zip(host, div)] for b in range(bands)]

    def edge(b: int, nb: int, k: int, top: bool):
        """Plane k's halo rows of band nb for band b, on b's card."""
        if not 0 <= nb < bands:
            return None
        rows, d = halo // div[k], div[k]
        if slice_of[nb] == slice_of[b]:         # a run of its own slice
            src = parts[nb][k][-rows:] if top else parts[nb][k][:rows]
        else:                                   # another slice's, relayed
            y0, y1 = b * Hb // d, (b + 1) * Hb // d
            src = host[k][y0 - rows:y0] if top else host[k][y1:y1 + rows]
        return src.to(devs[b])

    before = _by_device()
    err = {"me_halfpel": 0, "me_search": 0}
    timed = None
    for b in range(bands):
        dev = devs[b]
        ext = tuple(edge(b, b + (-1 if top else 1), k, top)
                    for k in (1, 2, 3) for top in (True, False))
        stacks = torchme.extend_bands(*(p[None] for p in parts[b]), halo,
                                      ext=ext, edge_top=b == 0,
                                      edge_bot=b == bands - 1)
        check(tuple(stacks[0].shape) == (1, Hb + 2 * halo, w),
              f"farm slice stack {tuple(stacks[0].shape)}")
        with torch.cuda.device(dev):
            centers = torchme.banded_centers_from(
                parts[b][0][None], parts[b][1][None],
                torch.tensor([4, -6], dtype=torch.int32, device=dev),
                (Hb,), halo)
            lam = torchme.lambda_for(27, dev)
            planes = torchme.halfpel_planes_cuda(stacks[1])
            got = torchme.me_search_planes_cuda(stacks[0], planes, stacks[2],
                                                stacks[3], centers, lam)
            torch.cuda.synchronize(dev)
        e = int((planes.to(torch.int32) - torchme.halfpel_planes_ref(
            stacks[1]).to(torch.int32)).abs().max())
        err["me_halfpel"] = max(err["me_halfpel"], e)
        want = torchme.me_search_ref(*stacks, centers, lam)
        for name, a, c in zip(("mv", "pred_y", "pred_u", "pred_v"),
                              got, want):
            e = int((a.to(torch.int32) - c.to(torch.int32)).abs().max())
            err["me_search"] = max(err["me_search"], e)
            check(a.shape == c.shape and e == 0,
                  f"farm band {b}: {name} differs (max |diff| {e})")
        if b == 1:
            timed = (stacks, planes, centers, lam)
    after = _by_device()
    launches = {name: {i: n - before[name].get(i, 0)
                       for i, n in after[name].items()
                       if n != before[name].get(i, 0)} for name in after}
    check(err["me_halfpel"] == 0,
          f"farm slice planes differ (max |diff| {err['me_halfpel']})")
    want_launches = {}
    for d in devs[:bands]:
        want_launches[d.index] = want_launches.get(d.index, 0) + 1
    for name, got_launches in launches.items():
        check(got_launches == want_launches,
              f"farm slice stacks: {name} launched {got_launches} times by "
              f"card index, want one a run: {want_launches}")
    print(f"farm slices {list(groups)} of plan_bands(135, 240, {bands}): "
          f"{bands} (1, {Hb + 2 * halo}, {w}) stacks, each on its run's card "
          f"({[str(d) for d in devs[:bands]]}), other slices' rows injected, "
          "runs of a slice copied card to card: one launch each "
          f"({launches}), planes and outputs bit-exact against the plain "
          "version", flush=True)
    # timing on band 1's stack, as the banded launch is timed
    stacks, planes, centers, lam = timed
    He = Hb + 2 * halo
    fns = {"me_halfpel": (lambda: torchme.halfpel_planes_cuda(stacks[1]),
                          lambda: torchme.halfpel_planes_ref(stacks[1])),
           "me_search": (lambda: torchme.me_search_planes_cuda(
               stacks[0], planes, stacks[2], stacks[3], centers, lam),
               lambda: torchme.me_search_ref(*stacks, centers, lam))}
    bounds = me_bounds(He, w, 1)
    out = {}
    with torch.cuda.device(devs[1]):
        for name, (kernel, plain) in fns.items():
            runs = [_graph_ms(kernel) for _ in range(2)]
            ms = min(runs)
            plain_ms = _median_ms(plain, reps=3)
            bound_ms, bound_by = _bound(*bounds[name])
            print(f"{name} farm band 1 of {bands} (1, {He}, {w}) on "
                  f"{devs[1]}: {ms:.4f} ms a launch (CUDA graph of 50, "
                  f"median of 5; runs {runs}); plain {plain_ms:.3f} ms; "
                  f"bound {bound_ms:.4f} ms by {bound_by}, "
                  f"{100 * bound_ms / ms:.1f}% of bound", flush=True)
            out[name] = {"shape": [1, He, w], "max_abs_err": err[name],
                         "launches_by_card": launches[name], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by}
    return out


# ---- phase 4 -----------------------------------------------------------

def main_path(w: int = 1920, h: int = 1080, n: int = 16, qp: int = 27,
              gop: int = 8) -> dict:
    frames = make_frames(n, w, h)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    enc = GopShardEncoder(meta, qp=qp, gop_frames=gop, device="cuda")
    concat_segments(enc.encode(frames))          # warm-up pass
    torch.cuda.synchronize()

    torchme.ME_PREPASS_LAUNCHES = 0
    torchme.ME_KERNEL_LAUNCHES = 0
    enc.stages.reset()
    t0 = time.perf_counter()
    stream = concat_segments(enc.encode(frames))
    t_cold = time.perf_counter() - t0
    launches = {"me_halfpel": torchme.ME_PREPASS_LAUNCHES,
                "me_search": torchme.ME_KERNEL_LAUNCHES}
    snap = enc.stages.snapshot()
    p_frames = n - len(enc.plan(n).gops)
    print(f"main path {w}x{h} x{n} gop {gop} qp {qp}: {len(stream)} "
          f"bytes, sha256 {hashlib.sha256(stream).hexdigest()}, "
          f"{n / t_cold:.3f} fps through encode() (staging included), "
          f"ME launches {launches}, "
          f"dense_fallback_waves {snap['dense_fallback_waves']}",
          flush=True)
    check(snap["dense_fallback_waves"] == 0,
          "the 1080p bench content fell back to the dense transfer")
    for name, count in launches.items():
        check(count == p_frames,
              f"{name} launched {count} times, want {p_frames} (one per "
              "P frame)")
    check(stream.startswith(b"\x00\x00\x00\x01\x67"),
          "stream does not start with an SPS NAL")
    nal_ref, nal_type, rbsp = split_annexb(stream[:64])[0]
    sps = headers.SPS.parse_rbsp(rbsp)
    check(nal_type == 7 and (sps.width, sps.height) == (w, h),
          f"SPS parses to {sps.width}x{sps.height}, want {w}x{h}")
    types = [u[1] for u in split_annexb(stream)]
    check(types.count(5) == len(enc.plan(n).gops)
          and types.count(1) == p_frames,
          f"slice NAL types {types}")

    # bench-style figures (bench.py _run_pipeline): pre-staged waves
    _, waves = enc.prepare_waves(frames)
    torch.cuda.synchronize()
    t_dev = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [enc.dispatch_wave(wv)[7] for wv in waves]
        _ = outs[-1][2].cpu()
        t_dev = min(t_dev, time.perf_counter() - t0)
    t_e2e, stage_ms = float("inf"), {}
    for _ in range(3):
        enc.stages.reset()
        t0 = time.perf_counter()
        segs = enc.encode_waves(waves)
        with enc.stages.stage("concat"):
            s2 = concat_segments(segs)
        t = time.perf_counter() - t0
        check(s2 == stream, "a repeated 1080p encode changed the bytes")
        if t < t_e2e:
            t_e2e, stage_ms = t, enc.stages.snapshot()
    print(f"main path bench-style: e2e {n / t_e2e:.3f} fps, device-only "
          f"{n / t_dev:.3f} fps (best of 3, waves pre-staged)")
    print(f"stage_ms {json.dumps(stage_ms)}", flush=True)
    return {"launches": launches, "stream": stream,
            "h2d_bytes": snap["h2d_bytes"], "e2e_fps": round(n / t_e2e, 3)}


def _sync_ms(fn, reps: int = 3) -> float:
    """Host wall-clock ms of one call that ends in a device synchronize
    (launch overhead included), best of `reps`."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def time_breakdown(dev, w: int = 1920, h: int = 1080, qp: int = 27,
                   gop: int = 8) -> None:
    """Where one 1080p GOP's time goes: the GOP program, with and
    without the transfer pack, and each of its parts timed alone (host
    clock around a synchronize, so launch overhead counts)."""
    from thinvids_tpu_torch.codecs.h264 import torchcore, torchinter
    from thinvids_tpu_torch.parallel.dispatch import _per_gop_sparse

    frames = [f.padded(16) for f in make_frames(gop, w, h)]
    ys, us, vs = (torch.from_numpy(np.stack([getattr(f, p) for f in frames]))
                  .to(dev) for p in "yuv")
    mbh, mbw = ys.shape[1] // 16, ys.shape[2] // 16
    qpc = torchcore.chroma_qp(qp)
    _, (ry, ru, rv) = torchinter._intra_frame_outputs(
        ys[0], us[0], vs[0], qp, mbw=mbw, mbh=mbh)
    cy, cu, cv = (a[1].to(torch.int16) for a in (ys, us, vs))
    pmv = torch.zeros(2, dtype=torch.int32, device=dev)
    cent = torchme.centers_from(cy, ry, pmv)
    lam = torchme.lambda_for(qp, dev)
    mv, py, pu, pv = torchme.me_search_cuda(cy, ry, ru, rv, cent, lam)
    parts = {
        "gop_total": lambda: torchinter.encode_gop_planes(
            ys, us, vs, qp, mbw=mbw, mbh=mbh),
        "intra_frame": lambda: torchinter._intra_frame_outputs(
            ys[0], us[0], vs[0], qp, mbw=mbw, mbh=mbh),
        "p_frame": lambda: torchinter._encode_p_plane(
            ys[1], us[1], vs[1], ry, ru, rv, pmv, qp, qpc, mbw=mbw,
            mbh=mbh),
        "p_centres": lambda: torchme.centers_from(cy, ry, pmv),
        "p_me_kernel": lambda: torchme.me_search_cuda(cy, ry, ru, rv, cent,
                                                      lam),
        "p_median": lambda: torchme.hist_median(mv.reshape(-1, 2), 32),
        "p_residual": lambda: torchinter._residual_p(
            cy, cu, cv, py, pu, pv, qp, qpc, mbw=mbw, mbh=mbh),
        # the per-GOP program of a wave: encode + device-side transfer pack
        "gop_with_pack": lambda: _per_gop_sparse(ys, us, vs, qp, mbw, mbh),
    }
    ms = {k: round(_sync_ms(fn), 3) for k, fn in parts.items()}
    print(f"breakdown_ms {w}x{h} gop {gop} qp {qp} (host clock, synced, "
          f"best of 3): {json.dumps(ms)}", flush=True)


# ---- phase 5 -----------------------------------------------------------

def card_equals_cpu() -> None:
    w, h, n, qp, gop = 352, 288, 24, 27, 8
    frames = make_frames(n, w, h, seed=5, pan=2)
    meta = VideoMeta(width=w, height=h, num_frames=n)
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        enc = GopShardEncoder(meta, qp=qp, gop_frames=gop, device=device)
        out[device] = concat_segments(enc.encode(frames))
        print(f"parity 352x288 x{n} on {device}: {len(out[device])} bytes "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)
    check(out["cuda"] == out["cpu"], "card and CPU streams differ")
    print("parity 352x288: card and CPU streams identical")


# ---- phases 6-8 ----------------------------------------------------------

def _job_settings():
    from thinvids_tpu_torch.core.config import DEFAULT_SETTINGS, Settings

    return Settings(values=dict(DEFAULT_SETTINGS, gop_frames=8))


def _write_clip(path: str, frames, w: int, h: int) -> None:
    from thinvids_tpu_torch.io.y4m import write_y4m

    write_y4m(path, VideoMeta(width=w, height=h, fps_num=30, fps_den=1,
                              num_frames=len(frames)), frames)


def _run_job(path: str, device: str) -> tuple[bytes, bytes]:
    """The reference executor's transcode steps, port modules only:
    (Annex-B stream, MP4 bytes)."""
    from thinvids_tpu_torch.ingest.decode import open_video
    from thinvids_tpu_torch.io.mp4 import mux_mp4
    from thinvids_tpu_torch.parallel.dispatch import make_shard_encoder

    with open_video(path) as src:
        enc = make_shard_encoder(src.meta, _job_settings(), None,
                                 device=device)
        stream = concat_segments(enc.encode(src))
        return stream, mux_mp4(stream, src.meta, audio=src.audio)


def job_path(tmp: str, main_stream: bytes, w: int = 1920, h: int = 1080,
             n: int = 16) -> bytes:
    path = os.path.join(tmp, "job1080.y4m")
    _write_clip(path, make_frames(n, w, h), w, h)
    torch.cuda.synchronize()
    torchme.ME_PREPASS_LAUNCHES = 0
    torchme.ME_KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    stream, mp4 = _run_job(path, "cuda")
    t_job = time.perf_counter() - t0
    launches = {"me_halfpel": torchme.ME_PREPASS_LAUNCHES,
                "me_search": torchme.ME_KERNEL_LAUNCHES}
    print(f"job path {w}x{h} x{n} (y4m → open_video → make_shard_encoder → "
          f"encode → concat → mux_mp4): MP4 {len(mp4)} bytes, sha256 "
          f"{hashlib.sha256(mp4).hexdigest()}; Annex-B {len(stream)} bytes, "
          f"sha256 {hashlib.sha256(stream).hexdigest()}; {n / t_job:.3f} "
          f"fps over the whole job ({t_job:.3f} s); ME launches {launches}",
          flush=True)
    check(stream == main_stream, "the job path's stream differs from the "
                                 "main path's")
    for name, count in launches.items():
        check(count == 14, f"job path: {name} launched {count} times, "
                           "want 14")
    check(mp4[4:8] == b"ftyp" and b"moov" in mp4[:4096],
          "the job's MP4 does not start with ftyp + moov")
    return mp4


def _shutdown_sidecars(enc) -> None:
    _shutdown_pool(enc._proc_pool)


def _shutdown_pool(pool) -> None:
    """Stop a process pool, waiting at most 30 s for each process."""
    if pool is None:
        return
    procs = list((getattr(pool, "_processes", None) or {}).values())
    pool.shutdown(wait=False, cancel_futures=True)
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()


def job_parity(tmp: str, w: int = 352, h: int = 288, n: int = 24) -> None:
    frames = make_frames(n, w, h, seed=5, pan=2)
    path = os.path.join(tmp, "job352.y4m")
    _write_clip(path, frames, w, h)
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[device] = _run_job(path, device)
        print(f"job parity 352x288 x{n} on {device}: MP4 "
              f"{len(out[device][1])} bytes in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    check(out["cuda"][1] == out["cpu"][1], "card and CPU MP4s differ")
    default = out["cuda"][0]
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    intra = {}
    for device in ("cuda", "cpu"):
        enc = GopShardEncoder(meta, qp=27, gop_frames=8, inter=False,
                              device=device)
        intra[device] = concat_segments(enc.encode(frames))
    check(intra["cuda"] == intra["cpu"], "all-intra: card and CPU differ")
    enc = GopShardEncoder(meta, qp=27, gop_frames=8, compact_transfer=False,
                          device="cuda")
    check(concat_segments(enc.encode(frames)) == default,
          "compact_transfer=False changed the bytes")
    enc = GopShardEncoder(meta, qp=27, gop_frames=8, pack_backend="process",
                          device="cuda")
    try:
        check(enc._proc_pool is not None, "no pack sidecar pool started")
        got = concat_segments(enc.encode(frames))
        gops = enc.stages.snapshot()["proc_pack_gops"]
    finally:
        _shutdown_sidecars(enc)
    want_gops = len(enc.plan(n).gops)
    check(got == default, "pack_backend=process changed the bytes")
    check(gops == want_gops, f"the sidecars packed {gops} GOPs, want "
                             f"{want_gops}")
    print(f"job parity 352x288: card MP4 == CPU MP4 ({len(out['cuda'][1])} "
          f"bytes); all-intra card == CPU ({len(intra['cuda'])} bytes); "
          f"compact_transfer=False and pack_backend=process ({gops} GOPs on "
          "the sidecars) give the default stream", flush=True)


def intra_wave(w: int = 1920, h: int = 1080, n: int = 8) -> None:
    frames = make_frames(n, w, h, seed=1)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    enc = GopShardEncoder(meta, qp=27, gop_frames=n, inter=False,
                          device="cuda")
    _, waves = enc.prepare_waves(frames)
    check(len(waves) == 1, f"{len(waves)} all-intra waves, want 1")
    stream = concat_segments(enc.encode_waves(waves))     # warm-up
    best = float("inf")
    for _ in range(2):
        enc.stages.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s2 = concat_segments(enc.encode_waves(waves))
        best = min(best, time.perf_counter() - t0)
        check(s2 == stream, "a repeated all-intra wave changed the bytes")
    snap = enc.stages.snapshot()
    types = [u[1] for u in split_annexb(stream)]
    check(types.count(5) == n and types.count(1) == 0,
          f"all-intra slice NAL types {types}")
    print(f"intra wave {w}x{h} x{n} qp 27 (all-intra, one wave): "
          f"{len(stream)} bytes, sha256 {hashlib.sha256(stream).hexdigest()},"
          f" {n / best:.3f} fps (dispatch + collect, best of 2), "
          f"dense_fallback_waves {snap['dense_fallback_waves']}, stage_ms "
          f"{json.dumps(snap)}", flush=True)


# ---- phase 9 -------------------------------------------------------------

def _me_counts() -> dict:
    return {"me_halfpel": torchme.ME_PREPASS_LAUNCHES,
            "me_search": torchme.ME_KERNEL_LAUNCHES}


def _zero_me_counts() -> None:
    torchme.ME_PREPASS_LAUNCHES = 0
    torchme.ME_KERNEL_LAUNCHES = 0


def rd_point(w: int = 1920, h: int = 1080, n: int = 32, qp: int = 25) -> dict:
    """bench.py's _run_rd point on the card: RD off and every feature on,
    one closed GOP each through encode_gop; quality on the recon, bytes
    against the JAX package's."""
    from thinvids_tpu_torch.codecs.h264.encoder import encode_gop
    from thinvids_tpu_torch.tools.metrics import psnr, ssim, vmaf_proxy

    frames = make_frames(n, w, h)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    out = {}
    for name, rd in (("off", RD_OFF), ("on", RD_ALL)):
        torch.cuda.synchronize()
        _zero_me_counts()
        t0 = time.perf_counter()
        stream, recons = encode_gop(frames, meta, qp=qp, idr_pic_id=0,
                                    with_headers=True, return_recon=True,
                                    rd=rd, device="cuda")
        t_gop = time.perf_counter() - t0
        launches = _me_counts()
        ry = recons[0]
        ps = [psnr(f.y, ry[i][:h, :w]) for i, f in enumerate(frames)]
        ss = [ssim(f.y, ry[i][:h, :w]) for i, f in enumerate(frames)]
        p = float(np.mean([x for x in ps if np.isfinite(x)] or [99.0]))
        q = float(np.mean(ss))
        digest = hashlib.sha256(stream).hexdigest()
        out[name] = {"bits_per_frame": round(len(stream) * 8 / n),
                     "psnr_y": round(p, 2), "ssim_y": round(q, 4),
                     "vmaf_proxy": vmaf_proxy(p, q), "bytes": len(stream),
                     "sha256": digest, "launches": launches,
                     "gop_s": round(t_gop, 3)}
        print(f"rd point {w}x{h} x{n} gop {n} qp {qp} RD {name}: "
              f"{json.dumps(out[name])} (GOP seconds: one pass through "
              "encode_gop, host pack and recon fetch included)", flush=True)
        want_len, want_sha = RD_POINT_JAX[name]
        check((len(stream), digest) == (want_len, want_sha),
              f"RD {name}: the card's stream ({len(stream)} bytes, "
              f"{digest}) is not the JAX package's ({want_len}, {want_sha})")
        for kname, count in launches.items():
            check(count == n - 1, f"RD {name}: {kname} launched {count} "
                                  f"times, want {n - 1}")
    return {"frames": frames, "meta": meta, "qp": qp, "point": out}


def rd_shard_encoder(point: dict, gop: int = 8) -> None:
    """GopShardEncoder(rd=RD_ALL) over the RD point's frames equals the
    per-GOP encode_gop streams, concatenated."""
    from thinvids_tpu_torch.codecs.h264.encoder import encode_gop

    frames, meta, qp = point["frames"], point["meta"], point["qp"]
    enc = GopShardEncoder(meta, qp=qp, gop_frames=gop, rd=RD_ALL,
                          device="cuda")
    t0 = time.perf_counter()
    got = concat_segments(enc.encode(frames))
    t_enc = time.perf_counter() - t0
    gops = enc.plan(len(frames)).gops
    want = b"".join(encode_gop(frames[g.start_frame:g.end_frame], meta,
                               qp=qp, idr_pic_id=g.index, rd=RD_ALL,
                               device="cuda") for g in gops)
    check(got == want, "GopShardEncoder(rd=RD_ALL) differs from the "
                       "per-GOP encode_gop streams")
    snap = enc.stages.snapshot()
    check(snap["dense_fallback_waves"] == 0,
          "the RD_ALL shard encode fell back to the dense transfer")
    print(f"rd shard encoder {meta.width}x{meta.height} x{len(frames)} gop "
          f"{gop} RD_ALL: "
          f"{len(gops)} GOPs, {len(got)} bytes == per-GOP encode_gop, "
          f"{len(frames) / t_enc:.3f} fps through encode()", flush=True)


def _rd_parity_clip(w: int = 352, h: int = 288, n: int = 8):
    frames = make_frames(n, w, h, seed=7, pan=2)
    return frames, VideoMeta(width=w, height=h, fps_num=30, fps_den=1,
                             num_frames=n)


def _rd_parity_outputs(device: str) -> dict:
    """Phase 9's 352x288 parity encodes on one device: (stream, recon)
    of encode_gop for every RD config the CPU tests use, the all-intra
    wave with mode decision + AQ, and (on the CPU) the RD_ALL shard
    encoder with the thread pack."""
    from thinvids_tpu_torch.codecs.h264.encoder import encode_gop

    frames, meta = _rd_parity_clip()
    out = {name: encode_gop(frames, meta, qp=27, return_recon=True, rd=rd,
                            device=device)
           for name, rd in RD_TEST_CONFIGS.items()}
    enc = GopShardEncoder(meta, qp=27, gop_frames=4, inter=False,
                          rd=RdConfig(mode_decision=True, aq_q=4),
                          device=device)
    out["intra_md_aq4"] = concat_segments(enc.encode(frames))
    if device == "cpu":
        out["rd_all_thread_pack"] = concat_segments(GopShardEncoder(
            meta, qp=27, gop_frames=4, rd=RD_ALL, device="cpu").encode(frames))
    return out


def rd_card_equals_cpu(cpu_side) -> None:
    """The card's side of phase 9's 352x288 parity, each result against
    the CPU port's (`cpu_side()`: computed in a worker process while the
    card runs its side), bytes and recon."""
    frames, meta = _rd_parity_clip()
    card = _rd_parity_outputs("cuda")
    enc = GopShardEncoder(meta, qp=27, gop_frames=4, rd=RD_ALL,
                          pack_backend="process", device="cuda")
    try:
        check(enc._proc_pool is not None, "no pack sidecar pool started")
        got = concat_segments(enc.encode(frames))
        gops = enc.stages.snapshot()["proc_pack_gops"]
    finally:
        _shutdown_sidecars(enc)
    cpu = cpu_side()
    sizes = {}
    for name in RD_TEST_CONFIGS:
        (s_card, r_card), (s_cpu, r_cpu) = card[name], cpu[name]
        check(s_card == s_cpu, f"RD {name}: card and CPU streams differ")
        for a, b, plane in zip(r_card, r_cpu, "yuv"):
            check(np.array_equal(a, b),
                  f"RD {name}: card and CPU recon {plane} differ")
        sizes[name] = len(s_card)
    check(card["intra_md_aq4"] == cpu["intra_md_aq4"],
          "all-intra wave with mode decision + AQ: card and CPU differ")
    check(got == cpu["rd_all_thread_pack"],
          "RD_ALL process pack on the card differs from the CPU's thread "
          "pack")
    check(gops == 2, f"the sidecars packed {gops} RD_ALL GOPs, want 2")
    print(f"rd parity {meta.width}x{meta.height} x{meta.num_frames}: card "
          f"== CPU (bytes and recon) for {json.dumps(sizes)}; all-intra "
          f"md+aq4 card == CPU ({len(card['intra_md_aq4'])} bytes); RD_ALL "
          f"process pack on the card == CPU ({len(got)} bytes, {gops} GOPs "
          "on the sidecars)", flush=True)


def rd_breakdown(dev, w: int = 1920, h: int = 1080, qp: int = 25) -> dict:
    """Where the RD features' time goes at 1080p: the IDR frame per
    feature set, one P frame with the P_Skip bias and the filter, and the
    filter alone (host clock around a synchronize, one timed round after
    a warm-up round; the filter also by CUDA events, median of 5)."""
    from thinvids_tpu_torch.codecs.h264 import torchcore, torchinter
    from thinvids_tpu_torch.codecs.h264.torchdeblock import \
        deblock_frame_torch

    frames = [f.padded(16) for f in make_frames(2, w, h)]
    ys, us, vs = (torch.from_numpy(np.stack([getattr(f, p) for f in frames]))
                  .to(dev) for p in "yuv")
    mbh, mbw = ys.shape[1] // 16, ys.shape[2] // 16
    qpc = torchcore.chroma_qp(qp)
    p_rd = RdConfig(pskip=True, deblock=True)
    _, (ry, ru, rv) = torchinter._intra_frame_outputs(
        ys[0], us[0], vs[0], qp, mbw=mbw, mbh=mbh, rd=RD_ALL)
    pmv = torch.zeros(2, dtype=torch.int32, device=dev)
    # the filter's inputs as the P step feeds them
    cy, cu, cv = (a[1].to(torch.int16) for a in (ys, us, vs))
    mv, py, pu, pv, _ = torchme.me_search(cy, ry, ru, rv, pmv, qp)
    res = torchinter._residual_p(cy, cu, cv, py, pu, pv, qp, qpc, mbw=mbw,
                                 mbh=mbh, rd=p_rd)
    qp_map = torch.full((mbh, mbw), qp, dtype=torch.int32, device=dev)
    core = torchcore._intra_core(ys[0], us[0], vs[0], qp, mbw=mbw, mbh=mbh,
                                 rd=RD_ALL)
    ri = tuple(a.to(torch.int16) for a in core[4:7])
    qp_map_i = (qp + core[9]).reshape(mbh, mbw)

    def idr(rd):
        return lambda: torchinter._intra_frame_outputs(
            ys[0], us[0], vs[0], qp, mbw=mbw, mbh=mbh, rd=rd)

    def pf(rd):
        return lambda: torchinter._encode_p_plane(
            ys[1], us[1], vs[1], ry, ru, rv, pmv, qp, qpc, mbw=mbw, mbh=mbh,
            rd=rd)

    deb_i = lambda: deblock_frame_torch(*ri, qp_map_i, intra=True)  # noqa: E731
    deb_p = lambda: deblock_frame_torch(  # noqa: E731
        *res[3:6], qp_map, intra=False, nz4=res[6], mv=mv)
    parts = {
        "idr_rd_off": idr(RD_OFF),
        "idr_mode_decision": idr(RdConfig(mode_decision=True)),
        "idr_aq": idr(RdConfig(aq_q=aq_from_strength(1.0))),
        "idr_deblock": idr(RdConfig(deblock=True)),
        "idr_rd_all": idr(RD_ALL),
        "p_rd_off": pf(RD_OFF),
        "p_pskip": pf(RdConfig(pskip=True)),
        "p_pskip_deblock": pf(p_rd),
        "p_residual_rd_off": lambda: torchinter._residual_p(
            cy, cu, cv, py, pu, pv, qp, qpc, mbw=mbw, mbh=mbh),
        "p_residual_pskip": lambda: torchinter._residual_p(
            cy, cu, cv, py, pu, pv, qp, qpc, mbw=mbw, mbh=mbh,
            rd=RdConfig(pskip=True)),
        "deblock_intra": deb_i,
        "deblock_p": deb_p,
    }
    # in turns: every part once per round, a warm-up round then one timed
    # round, so a drift of the shared host's speed spreads over all parts
    ms = {}
    for timed in (False, True):
        for k, fn in parts.items():
            t = _sync_ms(fn, reps=1)
            if timed:
                ms[k] = round(t, 3)
    events = {"deblock_intra": round(_median_ms(deb_i), 3),
              "deblock_p": round(_median_ms(deb_p), 3)}
    print(f"rd breakdown_ms {w}x{h} qp {qp} (host clock, synced, one round "
          f"in turns after a warm-up round): {json.dumps(ms)}", flush=True)
    print(f"rd deblock_frame_torch {w}x{h} by CUDA events (median of 5, one "
          f"call each): {json.dumps(events)}", flush=True)
    # the RD_ALL IDR frame (177,539 kernels, PERF.md) is not traced again
    t0 = time.perf_counter()
    busy = {k: _device_busy(parts[k]) for k in
            ("idr_rd_off", "p_rd_off", "p_pskip_deblock")}
    print(f"rd device busy {w}x{h} (torch.profiler, one call each: kernels "
          f"launched, their summed device ms, the call's wall ms under the "
          f"profiler): {json.dumps(busy)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return {"host_ms": ms, "event_ms": events, "busy": busy}


def _device_busy(fn) -> dict | str:
    """Kernels one call launches and the device time they take, from a
    torch.profiler trace of the call; the rest of its wall time the card
    idles while the host enqueues."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the call itself must not fail quietly: only the profiler is optional
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        if not dev:
            return "not measured (the trace holds no device events)"
        busy_us = sum(e.self_device_time_total for e in dev)
        return {"kernels": sum(e.count for e in dev),
                "device_ms": round(busy_us / 1e3, 3),
                "wall_ms": round(wall * 1e3, 3),
                "busy_share": round(busy_us / 1e3 / (wall * 1e3), 4)}
    except Exception as exc:  # noqa: BLE001 - the trace is optional
        return f"not measured ({type(exc).__name__}: {exc})"


def rd_phase(dev) -> None:
    secs = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = round(time.perf_counter() - t0, 1)
        return out

    point = timed("rd_point", rd_point)
    timed("rd_shard_encoder", rd_shard_encoder, point)
    timed("rd_breakdown", rd_breakdown, dev)
    print(f"rd phase seconds {json.dumps(secs)}", flush=True)
    on, off = point["point"]["on"], point["point"]["off"]
    print(f"rd point summary: on {on['bits_per_frame']} bits/frame at "
          f"{on['psnr_y']} dB, off {off['bits_per_frame']} at "
          f"{off['psnr_y']} dB; both streams equal the JAX package's",
          flush=True)


# ---- phase 10 ------------------------------------------------------------

def _slice_firsts(stream: bytes) -> list[list[int]]:
    """first_mb_in_slice of every slice, grouped per picture (a picture
    starts at each slice whose first_mb is 0)."""
    from thinvids_tpu_torch.io.bits import slice_first_mb
    from thinvids_tpu_torch.io.mp4 import split_annexb as raw_nals

    pics: list[list[int]] = []
    for nal in raw_nals(stream):
        if nal[0] & 0x1F in (1, 5):
            first = slice_first_mb(nal)
            if first == 0:
                pics.append([])
            pics[-1].append(first)
    return pics


def _sfe_encoder(meta, qp, gop, bands, halo, rd=RD_OFF, device="cuda"):
    from thinvids_tpu_torch.parallel.dispatch import SfeShardEncoder

    return SfeShardEncoder(meta, qp=qp, gop_frames=gop, bands=bands,
                           halo_rows=halo, rd=rd, device=device)


def sfe_point(w: int = 3840, h: int = 2160, n: int = 16, gop: int = 8,
              qp: int = 27, bands: int = 4, halo: int = 32,
              budget_s: float = 40.0) -> dict:
    """bench.py's _run_sfe point on the card: every frame split into 4
    MB-row bands, each its own slice, through SfeShardEncoder.encode;
    the stream against the JAX package's; then _run_sfe's figures over
    pre-staged waves (a warm-up GOP, then the best of as many timed
    passes as `budget_s` allows, at least two)."""
    import statistics

    frames = make_frames(n, w, h)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    enc = _sfe_encoder(meta, qp, gop, bands, halo)
    check(enc.num_bands == bands and enc.halo_rows == halo,
          f"{enc.num_bands} bands, halo {enc.halo_rows}")
    _, waves = enc.prepare_waves(frames)
    concat_segments(enc.encode_waves(waves[:1]))         # warm-up GOP
    torch.cuda.synchronize()

    _zero_me_counts()
    enc.stages.reset()
    t0 = time.perf_counter()
    stream = concat_segments(enc.encode(frames))
    t_enc = time.perf_counter() - t0
    launches = _me_counts()
    digest = hashlib.sha256(stream).hexdigest()
    snap = enc.stages.snapshot()
    p_frames = n - len(enc.plan(n).gops)
    print(f"sfe point {w}x{h} x{n} gop {gop} qp {qp} bands {bands} halo "
          f"{halo}: {len(stream)} bytes, sha256 {digest}, {n / t_enc:.3f} fps "
          f"through encode() (staging included), ME launches {launches}, "
          f"dense_fallback_waves {snap['dense_fallback_waves']}", flush=True)
    want_len, want_sha = SFE_POINT_JAX["bench_2160p"]
    check((len(stream), digest) == (want_len, want_sha),
          f"SFE point: the card's stream ({len(stream)} bytes, {digest}) is "
          f"not the JAX package's ({want_len}, {want_sha})")
    for name, count in launches.items():
        check(count == p_frames, f"SFE point: {name} launched {count} times, "
                                 f"want {p_frames} (one per P frame, all "
                                 "bands in one launch)")
    mbw = (w + 15) // 16
    starts = [b.start_mb_row * mbw for b in enc.band_plan.bands]
    check(starts == [0, 34 * mbw, 68 * mbw, 102 * mbw],
          f"band slice starts {starts}")
    pics = _slice_firsts(stream)
    check(len(pics) == n and all(p == starts for p in pics),
          f"{len(pics)} pictures; slice starts of the first: {pics[:1]}")

    runs, t_best, lat, stage_ms = 0, float("inf"), [], {}
    t_start = time.perf_counter()
    while runs < 2 or (time.perf_counter() - t_start) * (runs + 1) / runs \
            < budget_s:
        enc.stages.reset()
        enc.frame_done_t.clear()
        t0 = time.perf_counter()
        s2 = concat_segments(enc.encode_waves(waves))
        t = time.perf_counter() - t0
        runs += 1
        check(s2 == stream, "a repeated SFE pass changed the bytes")
        if t < t_best:
            t_best, lat = t, enc.frame_latencies_ms()
            stage_ms = enc.stages.snapshot()
    lat_sorted = sorted(lat) or [0.0]
    fig = {"fps": round(n / t_best, 3),
           "latency_ms_p50": round(statistics.median(lat_sorted), 3),
           "latency_ms_p99": round(
               lat_sorted[int(0.99 * (len(lat_sorted) - 1))], 3),
           "bands": enc.num_bands, "halo_rows": enc.halo_rows,
           "bytes": len(stream), "passes": runs}
    print(f"sfe point figures (bench _run_sfe's, best of {runs} passes over "
          f"pre-staged waves): {json.dumps(fig)}", flush=True)
    print(f"sfe stage_ms {json.dumps(stage_ms)}", flush=True)
    print(f"sfe per-frame latencies ms (best pass, sorted gaps): "
          f"{[round(x, 3) for x in lat_sorted]}", flush=True)
    return {"launches": launches, "enc": enc, "waves": waves, "qp": qp,
            "fig": fig}


def sfe_breakdown(dev, point: dict) -> dict:
    """One banded IDR step, one banded P step (host clock around a
    synchronize, best of 2), and the banded search of that P step by
    CUDA events: the whole me_search_banded (halo exchange, probe,
    median) and its two kernel launches alone."""
    enc, waves, qp = point["enc"], point["waves"], point["qp"]
    _, ys, us, vs, _ = waves[0]
    from thinvids_tpu_torch.parallel.dispatch import (_sfe_p_step,
                                                      _sfe_probe_step)

    _, carry = enc._intra_step(ys[0], us[0], vs[0], qp)
    ry, ru, rv = carry
    pmv = torch.zeros(2, dtype=torch.int32, device=dev)
    cy = ys[1].to(torch.int16)
    bp = enc.band_plan
    real = enc._real_rows
    halo = enc.halo_rows
    edges = (True, True)

    def p_step():
        # one P frame as the one-entry walk steps it: the probe, its
        # center, then the step
        cost = _sfe_probe_step(ys[1], ry, real, None, None, edges)
        return _sfe_p_step(ys[1], us[1], vs[1], carry, pmv,
                           torchme.probe_center_t(cost), (None,) * 6, qp,
                           real, edges, mbw=bp.mb_width,
                           mbh_band=bp.band_mb_rows, halo_rows=halo,
                           rd=enc.rd)

    ms = {
        "idr_step": _sync_ms(lambda: enc._intra_step(ys[0], us[0], vs[0],
                                                     qp), reps=2),
        "p_step": _sync_ms(p_step, reps=2),
    }
    B, Hb, W = cy.shape
    cur_s, ref_s, ru_s, rv_s = torchme.extend_bands(cy, ry, ru, rv, halo)
    centers = torchme.banded_centers_from(cy, ry, pmv, real, halo)
    lam = torchme.lambda_for(qp, dev)
    events = {
        "me_search_banded": _median_ms(lambda: torchme.me_search_banded(
            cy, ry, ru, rv, pmv, qp, halo_rows=halo, real_rows=real)),
        "me_kernels": _median_ms(lambda: torchme.me_search_cuda(
            cur_s, ref_s, ru_s, rv_s, centers, lam)),
    }
    print(f"sfe breakdown_ms {bp.num_bands} bands of {B}x{Hb}x{W} (host "
          f"clock, synced, best of 2): {json.dumps({k: round(v, 3) for k, v in ms.items()})}; "
          f"by CUDA events (median of 5): "
          f"{json.dumps({k: round(v, 4) for k, v in events.items()})}",
          flush=True)
    return {"host_ms": ms, "event_ms": events}


def sfe_rd_point(w: int = 1920, h: int = 1080, n: int = 16, gop: int = 8,
                 qp: int = 25, bands: int = 4, halo: int = 32) -> None:
    """Split-frame encoding with mode decision, the P_Skip bias and the
    in-loop filter on (and aq_strength 1.0 asked for, which the encoder
    strips): the band deblock's halo runs; the stream against the JAX
    package's."""
    frames = make_frames(n, w, h)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    enc = _sfe_encoder(meta, qp, gop, bands, halo, rd=RD_ALL)
    check(enc.rd == RdConfig(mode_decision=True, pskip=True, deblock=True),
          f"SFE RD config {enc.rd}")
    _zero_me_counts()
    t0 = time.perf_counter()
    stream = concat_segments(enc.encode(frames))
    t_enc = time.perf_counter() - t0
    launches = _me_counts()
    digest = hashlib.sha256(stream).hexdigest()
    print(f"sfe rd point {w}x{h} x{n} gop {gop} qp {qp} bands {bands} "
          f"{enc.rd}: {len(stream)} bytes, sha256 {digest}, "
          f"{n / t_enc:.3f} fps through encode() (one pass), ME launches "
          f"{launches}", flush=True)
    want_len, want_sha = SFE_POINT_JAX["rd_1080p"]
    check((len(stream), digest) == (want_len, want_sha),
          f"SFE RD point: the card's stream ({len(stream)} bytes, {digest}) "
          f"is not the JAX package's ({want_len}, {want_sha})")
    p_frames = n - len(enc.plan(n).gops)
    check(all(c == p_frames for c in launches.values()),
          f"SFE RD point: ME launches {launches}, want {p_frames} each")


def _sfe_parity_cases() -> dict:
    """The split-frame cases the CPU tests hold against the JAX package:
    1, 3 and 4 bands at 352x288 (4 gives a partial last band), 6
    one-MB-row bands at 352x96 (halo 32 clamped to the band height, 16),
    the escape content that forces the dense rerun, and the RD features
    on. name → (frames, meta, qp, bands, halo, rd)."""
    w, h, n = 352, 288, 4
    frames = make_frames(n, w, h, seed=5, pan=2)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    thin = make_frames(n, w, 96, seed=6, pan=2)
    rng = np.random.default_rng(7)
    noise = [Frame(y=rng.integers(0, 256, (h, w), dtype=np.uint8),
                   u=rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
                   v=rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
             for _ in range(4)]
    return {
        "bands1": (frames, meta, 27, 1, 32, RD_OFF),
        "bands3": (frames, meta, 27, 3, 32, RD_OFF),
        "bands4": (frames, meta, 27, 4, 32, RD_OFF),
        "thin6": (thin, VideoMeta(width=w, height=96, num_frames=n), 27, 6,
                  32, RD_OFF),
        "escape": (noise, VideoMeta(width=w, height=h, num_frames=4), 4, 4,
                   32, RD_OFF),
        "rd3": (frames, meta, 27, 3, 32,
                RdConfig(mode_decision=True, pskip=True, deblock=True)),
    }


def _sfe_parity_outputs(device: str, gop: int = 4) -> dict:
    """Every SFE parity case on one device: name → (stream, recon frames,
    bands, halo rows, dense_fallback_waves)."""
    out = {}
    for name, (fr, m, qp, bands, halo, rd) in _sfe_parity_cases().items():
        enc = _sfe_encoder(m, qp, gop, bands, halo, rd=rd, device=device)
        enc.keep_recon = True
        stream = concat_segments(enc.encode(fr))
        out[name] = (stream, [enc.recon_frames[i] for i in range(len(fr))],
                     enc.num_bands, enc.halo_rows,
                     enc.stages.snapshot()["dense_fallback_waves"])
    return out


def sfe_card_equals_cpu(cpu_side, gop: int = 4) -> None:
    """Card bytes == CPU bytes (`cpu_side()`: the CPU port's, computed in
    a worker process while the card runs) and recon for every SFE parity
    case; bands=1 also equals the GopShardEncoder stream at the same
    gop."""
    card = _sfe_parity_outputs("cuda", gop)
    frames, meta = _sfe_parity_cases()["bands1"][:2]
    gop_enc = GopShardEncoder(meta, qp=27, gop_frames=gop, device="cuda")
    gop_stream = concat_segments(gop_enc.encode(frames))
    cpu = cpu_side()
    sizes = {}
    for name, (s_card, r_card, bands, halo, dense) in card.items():
        s_cpu, r_cpu = cpu[name][:2]
        check(s_card == s_cpu, f"SFE {name}: card and CPU streams differ")
        for i, (fa, fb) in enumerate(zip(r_card, r_cpu, strict=True)):
            for a, b, plane in zip(fa, fb, "yuv"):
                check(np.array_equal(a, b),
                      f"SFE {name}: card and CPU recon {plane} of frame {i} "
                      "differ")
        if name == "thin6":
            check(halo == 16 and bands == 6,
                  f"thin bands: {bands} bands, halo {halo}")
        if name == "escape":
            check(dense >= 1, "the escape content did not rerun dense")
        else:
            check(dense == 0, f"SFE {name} fell back to the dense transfer")
        sizes[name] = len(s_card)
    check(gop_stream == card["bands1"][0],
          "SFE bands=1 differs from the GopShardEncoder stream")
    print(f"sfe parity: card == CPU (bytes and recon) for "
          f"{json.dumps(sizes)}; bands=1 == GopShardEncoder", flush=True)


def _cpu_side(name: str) -> dict:
    """The CPU port's outputs of one card == CPU check (a worker process's
    job: it never touches the card)."""
    torch.set_num_threads(2)
    return {"rd": _rd_parity_outputs, "sfe": _sfe_parity_outputs}[name]("cpu")


def sfe_phase(dev) -> dict:
    point = sfe_point()
    point["idr_step_ms"] = round(
        sfe_breakdown(dev, point)["host_ms"]["idr_step"], 3)
    del point["enc"], point["waves"]
    sfe_rd_point()
    return point


# ---- phase 11 ------------------------------------------------------------

def rc_point(w: int = 1920, h: int = 1080, n: int = 32, gop: int = 8,
             qp: int = 27, kbps: float = 8000.0) -> dict:
    """Two-pass VBR through the job's seam: make_shard_encoder builds the
    encoder from the job's settings, rc.encode_vbr2pass runs the analysis
    pass and the encode passes on it, concat_segments and mux_mp4 finish
    the job. The ME launches and seconds of every pass, each counted from
    0; the stream and QPs against the JAX package's."""
    from thinvids_tpu_torch.core.config import DEFAULT_SETTINGS, Settings
    from thinvids_tpu_torch.io.mp4 import mux_mp4
    from thinvids_tpu_torch.parallel import rc
    from thinvids_tpu_torch.parallel.dispatch import make_shard_encoder

    frames = make_frames(n, w, h)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    settings = Settings(values=dict(DEFAULT_SETTINGS, gop_frames=gop, qp=qp,
                                    rc_mode="vbr2pass",
                                    target_bitrate_kbps=kbps))
    enc = make_shard_encoder(meta, settings, None, device="cuda")
    marks: list = []            # (pass label, seconds, ME launches)
    t_mark = [0.0]

    def mark(label: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        marks.append((label, round(now - t_mark[0], 3), _me_counts()))
        _zero_me_counts()
        t_mark[0] = now

    def on_pass(pass_no, gop_qps) -> None:
        if pass_no == 1:
            torch.cuda.synchronize()
            _zero_me_counts()
            t_mark[0] = time.perf_counter()

    def encode_fn(e):
        if not marks:
            mark("analysis")
        segs = e.encode(frames)
        mark(f"pass {len(marks)}")
        return segs

    segs, stats = rc.encode_vbr2pass(
        frames, meta, kbps, base_qp=int(settings.qp), enc=enc,
        encode_fn=encode_fn, on_pass=on_pass)
    stream = concat_segments(segs)
    mp4 = mux_mp4(stream, meta)
    digest = hashlib.sha256(stream).hexdigest()
    print(f"rc point {w}x{h} x{n} gop {gop} base qp {qp} target {kbps} kbps: "
          f"shares {stats['complexity_shares']}, gop_qps {stats['gop_qps']}, "
          f"passes {stats['passes']}, pass-1 bits {stats['pass1_bits']}, "
          f"final bits {stats['pass2_bits']} (target "
          f"{stats['target_bits']}); stream {len(stream)} bytes, sha256 "
          f"{digest}; MP4 {len(mp4)} bytes", flush=True)
    print(f"rc passes (seconds, ME launches): {json.dumps(marks)}",
          flush=True)
    check(marks[0][0] == "analysis" and not any(marks[0][2].values()),
          f"the analysis pass launched ME kernels: {marks[0]}")
    p_frames = n - len(enc.plan(n).gops)
    check(len(marks) == stats["passes"] + 1
          and all(c == p_frames for m in marks[1:] for c in m[2].values()),
          f"ME launches per pass {marks}, want {p_frames} each")
    check((len(stream), digest) == (RC_POINT_JAX["bytes"],
                                    RC_POINT_JAX["sha256"]),
          f"rc point: the card's stream ({len(stream)} bytes, {digest}) is "
          f"not the JAX package's {RC_POINT_JAX}")
    check(stats["gop_qps"] == RC_POINT_JAX["gop_qps"]
          and stats["passes"] == RC_POINT_JAX["passes"],
          f"rc point: gop_qps {stats['gop_qps']} / passes {stats['passes']} "
          f"are not the JAX package's {RC_POINT_JAX}")
    check(mp4[4:8] == b"ftyp", "the rc job's MP4 does not start with ftyp")
    return {"launches_per_pass": marks[1][2]}


# ---- phase 12 ------------------------------------------------------------

def _record_planes(ladder) -> dict:
    """Wrap every scaler of `ladder` to keep, per wave, the padded source
    planes it was given and the planes it returned, on the host:
    {rung name: [((ys, us, vs), (sy, su, sv)) per wave]}."""
    seen = {}
    for rung, scaler in zip(ladder.rungs, ladder.scalers):
        if scaler is None:
            continue
        seen[rung.name] = []

        def record(ys, us, vs, _scale=scaler.scale_wave,
                   _out=seen[rung.name]):
            planes = _scale(ys, us, vs)
            _out.append((tuple(p.cpu().numpy() for p in (ys, us, vs)),
                         tuple(p.cpu().numpy() for p in planes)))
            return planes

        scaler.scale_wave = record
    return seen


def _wave_frames(waves, planes) -> list:
    """Frames (in frame order) out of per-wave (G, F, H, W) plane stacks,
    each GOP cut to its own frame count."""
    out = []
    for wave, (sy, su, sv) in zip(waves, planes):
        for gi, g in enumerate(wave):
            for f in range(g.num_frames):
                out.append((g.start_frame + f,
                            Frame(y=sy[gi, f], u=su[gi, f], v=sv[gi, f])))
    return [f for _, f in sorted(out, key=lambda t: t[0])]


def ladder_point(main: dict, w: int = 1920, h: int = 1080, n: int = 16,
                 gop: int = 8, qp: int = 27,
                 spec: str = "1080,720,480,360") -> dict:
    """bench.py's _run_ladder point on the card, through the job's seam
    (make_shard_encoder(rungs=)): the top rung against phase 4, the
    upload once per wave, the ME launches, every scaled plane against
    scale_plane_np, every lower rung against a plain encoder over the
    ladder's own planes, the rungs beside the JAX package's; then
    bench's figures."""
    from thinvids_tpu_torch.abr.ladder import plan_ladder, rung_segments
    from thinvids_tpu_torch.abr.scale import scale_plane_np
    from thinvids_tpu_torch.core.config import DEFAULT_SETTINGS, Settings
    from thinvids_tpu_torch.parallel.dispatch import make_shard_encoder

    frames = make_frames(n, w, h)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    settings = Settings(values=dict(DEFAULT_SETTINGS, qp=qp, gop_frames=gop,
                                    ladder_rungs=spec))
    rungs = plan_ladder(meta, settings)
    check([r.name for r in rungs] == list(LADDER_POINT_JAX),
          f"ladder rungs {rungs}")
    lad = make_shard_encoder(meta, settings, None, rungs=rungs,
                             device="cuda")
    check(type(lad).__name__ == "LadderShardEncoder",
          f"make_shard_encoder(rungs=) built {type(lad).__name__}")
    seen = _record_planes(lad)
    torch.cuda.synchronize()
    _zero_me_counts()
    lad.stages.reset()
    bundles = lad.encode(frames)
    launches = _me_counts()
    snap = lad.stages.snapshot()
    streams = {r.name: concat_segments(rung_segments(bundles, r.name))
               for r in rungs}
    p_frames = n - len(lad.plan(n).gops)
    print(f"ladder point {w}x{h} x{n} gop {gop} qp {qp} rungs {spec} "
          f"(qps {[r.qp for r in rungs]}): ME launches {launches}, "
          f"h2d_bytes {snap['h2d_bytes']} (phase 4: {main['h2d_bytes']})",
          flush=True)
    check(streams[rungs[0].name] == main["stream"],
          "the ladder's top rung differs from phase 4's stream")
    check(snap["h2d_bytes"] == main["h2d_bytes"],
          f"the ladder uploaded {snap['h2d_bytes']} bytes, phase 4 "
          f"{main['h2d_bytes']}")
    for name, count in launches.items():
        check(count == len(rungs) * p_frames,
              f"ladder: {name} launched {count} times, want "
              f"{len(rungs)} x {p_frames}")
    check(snap["dense_fallback_waves"] == 0,
          "the ladder fell back to the dense transfer")

    waves = [b.gop for b in bundles]
    wave_groups = [waves[i:i + lad.gops_per_wave]
                   for i in range(0, len(waves), lad.gops_per_wave)]
    for rung, scaler in zip(rungs, lad.scalers):
        if scaler is None:
            continue
        stream = streams[rung.name]
        digest = hashlib.sha256()
        counts = [0, 0, 0]
        for src, got in seen[rung.name]:
            for pi, (a, b) in enumerate(zip(src, got)):
                digest.update(np.ascontiguousarray(b).tobytes())
                mv, mh = ((scaler.y_v, scaler.y_h) if pi == 0
                          else (scaler.c_v, scaler.c_h))
                for gi in range(a.shape[0]):
                    for fi in range(a.shape[1]):
                        want = scale_plane_np(a[gi, fi], mv, mh)
                        d = np.abs(want.astype(np.int16)
                                   - b[gi, fi].astype(np.int16))
                        check(int(d.max()) <= 1,
                              f"rung {rung.name} plane {'yuv'[pi]}: "
                              f"{int(d.max())} LSB from scale_plane_np")
                        counts[pi] += int((d != 0).sum())
        # the rung against a plain encoder over the ladder's own planes
        rmeta = VideoMeta(width=rung.width, height=rung.height, fps_num=30,
                          fps_den=1, num_frames=n)
        plain = GopShardEncoder(rmeta, qp=rung.qp, gop_frames=gop,
                                device="cuda")
        rframes = _wave_frames(wave_groups, [got for _, got in
                                             seen[rung.name]])
        check(concat_segments(plain.encode(rframes)) == stream,
              f"rung {rung.name} differs from GopShardEncoder(qp "
              f"{rung.qp}) over the ladder's own planes")
        jlen, jsha, jplanes = LADDER_POINT_JAX[rung.name]
        sha = hashlib.sha256(stream).hexdigest()
        planes_sha = digest.hexdigest()
        same_planes = planes_sha == jplanes
        print(f"ladder rung {rung.name} {rung.width}x{rung.height} qp "
              f"{rung.qp}: {len(stream)} bytes, sha256 {sha}; JAX "
              f"{jlen}, {jsha}; planes sha256 {planes_sha}, JAX {jplanes}: "
              + ("the same planes, so the stream must be JAX's"
                 if same_planes else
                 "planes differ from JAX's (within 1 LSB), so the stream "
                 "may too")
              + f"; samples off scale_plane_np by 1 LSB "
              f"{dict(zip('yuv', counts))}; == GopShardEncoder over the "
              "ladder's planes", flush=True)
        if same_planes:
            check((len(stream), sha) == (jlen, jsha),
                  f"rung {rung.name}: the planes are JAX's, the stream is "
                  "not")
    jtop = LADDER_POINT_JAX[rungs[0].name]
    check((len(main["stream"]), hashlib.sha256(main["stream"]).hexdigest())
          == jtop[:2], "the top rung is not the JAX package's")
    _check_tf32_refused()

    for scaler in lad.scalers:
        if scaler is not None:
            del scaler.scale_wave             # drop the recording wrapper
    # encode() again, timed without the recording's copies to the host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = lad.encode(frames)
    t_enc = time.perf_counter() - t0
    check(all(concat_segments(rung_segments(again, r.name))
              == streams[r.name] for r in rungs),
          "a second encode() of the ladder changed the bytes")
    print(f"ladder point: {n * len(rungs) / t_enc:.3f} rung-frames/s "
          "through encode() (staging included; a second pass, without "
          "the plane recording)", flush=True)

    # bench's figures (bench.py _run_ladder): depth 1 over pre-staged
    # waves, best of 2 after a warm-up
    _, staged = lad._stager.prepare_waves(frames)
    torch.cuda.synchronize()

    def encode_staged():
        out = []
        for wv in staged:
            out.extend(lad.collect_wave(lad.dispatch_wave(wv)))
        return out

    encode_staged()
    t_best, stage_ms = float("inf"), {}
    for _ in range(2):
        lad.stages.reset()
        t0 = time.perf_counter()
        out = encode_staged()
        t = time.perf_counter() - t0
        check(all(concat_segments(rung_segments(out, r.name))
                  == streams[r.name] for r in rungs),
              "a repeated ladder pass changed the bytes")
        if t < t_best:
            t_best, stage_ms = t, lad.stages.snapshot()
    bits = {r.name: round(len(streams[r.name]) * 8 / n) for r in rungs}
    fig = {"fps": round(n * len(rungs) / t_best, 3), "rungs": len(rungs),
           "rung_bits_per_frame": bits, "h2d_bytes": main["h2d_bytes"],
           "scale_ms": stage_ms.get("scale")}
    print(f"ladder figures (bench _run_ladder's: aggregate rung-frames/s "
          f"over pre-staged waves, depth 1, best of 2 after a warm-up): "
          f"{json.dumps(fig)}", flush=True)
    print(f"ladder stage_ms {json.dumps(stage_ms)}", flush=True)
    return {"launches": launches}


def _check_tf32_refused() -> None:
    """The scaler refuses to run its products with TF32 allowed."""
    from thinvids_tpu_torch.abr.scale import PlaneScaler

    sc = PlaneScaler(64, 48, 32, 24, device="cuda")
    x = torch.zeros((48, 64), dtype=torch.uint8, device="cuda")
    c = torch.zeros((24, 32), dtype=torch.uint8, device="cuda")
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        sc.scale_wave(x, c, c)
    except RuntimeError as exc:
        check("allow_tf32" in str(exc), f"the scaler refused with {exc}")
    else:
        raise RuntimeError("check failed: the scaler ran with TF32 allowed")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    print("ladder scaler: refuses TF32 products (allow_tf32 on)", flush=True)


def ladder_job(tmp: str, main_stream: bytes, w: int = 1920, h: int = 1080,
               n: int = 16) -> dict:
    """A ladder job with port modules only: y4m → open_video →
    plan_ladder → make_shard_encoder(rungs=) → encode → rung_segments →
    hls.package_ladder → lint_ladder. Returns the tree's digest
    (`tree_digest`)."""
    from thinvids_tpu_torch.abr import hls
    from thinvids_tpu_torch.abr.ladder import plan_ladder, rung_segments
    from thinvids_tpu_torch.core.config import DEFAULT_SETTINGS, Settings
    from thinvids_tpu_torch.ingest.decode import open_video
    from thinvids_tpu_torch.parallel.dispatch import make_shard_encoder

    path = os.path.join(tmp, "ladder1080.ladder.y4m")
    _write_clip(path, make_frames(n, w, h), w, h)
    settings = Settings(values=dict(DEFAULT_SETTINGS, gop_frames=8))
    out_dir = os.path.join(tmp, "ladder1080.hls")
    t0 = time.perf_counter()
    with open_video(path) as src:
        rungs = plan_ladder(src.meta, settings)
        enc = make_shard_encoder(src.meta, settings, None, rungs=rungs,
                                 device="cuda")
        bundles = enc.encode(src)
        streams = [hls.RungStream(r.name, r.width, r.height,
                                  rung_segments(bundles, r.name),
                                  audio=src.audio) for r in rungs]
        hls.package_ladder(out_dir, streams, src.meta.fps_num,
                           src.meta.fps_den,
                           segment_s=float(settings.get("segment_s", 6.0)))
        info = hls.lint_ladder(out_dir, expected_duration_s=n / 30)
    t_job = time.perf_counter() - t0
    files = [os.path.join(d, f) for d, _, fs in os.walk(out_dir) for f in fs]
    total = sum(os.path.getsize(f) for f in files)
    print(f"ladder job {w}x{h} x{n} (y4m → open_video → plan_ladder → "
          f"make_shard_encoder(rungs=) → encode → package_ladder → "
          f"lint_ladder): {len(files)} files, {total} bytes, lint "
          f"{json.dumps(info)}, {t_job:.3f} s", flush=True)
    check(info["rungs"] == len(rungs) == 4, f"lint saw {info['rungs']} rungs")
    check(concat_segments(rung_segments(bundles, rungs[0].name))
          == main_stream, "the ladder job's top rung differs from phase 4's")
    return tree_digest(out_dir)


def tree_digest(root: str) -> dict:
    """{path under `root`: sha256 of the file} for every file below it."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            full = os.path.join(d, name)
            with open(full, "rb") as fp:
                out[os.path.relpath(full, root)] = (
                    os.path.getsize(full),
                    hashlib.sha256(fp.read()).hexdigest())
    return out


class _FixedPlanes:
    """A scaler that hands a ladder the planes another run recorded."""

    def __init__(self, waves: list):
        self._waves = list(waves)

    def scale_wave(self, ys, us, vs):
        return tuple(torch.from_numpy(p) for p in self._waves.pop(0))


def ladder_card_equals_cpu(w: int = 352, h: int = 288, n: int = 16,
                           gop: int = 8) -> None:
    """At 352x288 (rungs 240, 144) the CPU port's rung encoders, fed the
    card's scaled planes through the ladder's own dispatch, give the
    card's rung bytes (and the top rung the card's too)."""
    from thinvids_tpu_torch.abr.ladder import (LadderShardEncoder,
                                               plan_ladder, rung_segments)
    from thinvids_tpu_torch.core.config import DEFAULT_SETTINGS, Settings

    frames = make_frames(n, w, h, seed=5, pan=2)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    rungs = plan_ladder(meta, Settings(values=dict(
        DEFAULT_SETTINGS, qp=27, ladder_rungs="240,144")))
    card = LadderShardEncoder(meta, rungs, gop_frames=gop, device="cuda")
    seen = _record_planes(card)
    want = card.encode(frames)
    cpu = LadderShardEncoder(meta, rungs, gop_frames=gop, device="cpu")
    cpu.scalers = [None if s is None else
                   _FixedPlanes(got for _, got in seen[r.name])
                   for r, s in zip(rungs, card.scalers)]
    got = cpu.encode(frames)
    sizes = {}
    for r in rungs:
        a = concat_segments(rung_segments(want, r.name))
        b = concat_segments(rung_segments(got, r.name))
        check(a == b, f"rung {r.name}: the card's and the CPU's bytes "
                      "differ given the same planes")
        sizes[r.name] = len(a)
    print(f"ladder parity {w}x{h} x{n} rungs {[r.name for r in rungs]}: card "
          f"== CPU given the card's planes {json.dumps(sizes)}", flush=True)


def ladder_phase(main: dict) -> dict:
    import tempfile

    point = ladder_point(main)
    with tempfile.TemporaryDirectory(prefix="tvt-ladder-") as tmp:
        point["job_tree"] = ladder_job(tmp, main["stream"])
    return point


# ---- phase 13 ------------------------------------------------------------

def _measure_live_pace(meta, frames, rungs, gop_frames: int, fps: int,
                       segment_s: float,
                       warm_full: bool = False) -> tuple[float, float, list]:
    """bench.py's live pace probe with the port's ladder on the card:
    warm the pinned live batch shapes (the whole clip when `warm_full`,
    then one GOP twice) and measure a sustainable ingest pace — half the
    1-GOP edge rate, never above the stream's fps — and a segment
    duration provisioned to at least two GOP-walls. Returns
    (ingest_fps, segment_s, the whole clip's bundles when `warm_full`)."""
    from thinvids_tpu_torch.abr.ladder import LadderShardEncoder
    from thinvids_tpu_torch.cluster.executor import _live_batch_plan

    warm = LadderShardEncoder(meta, rungs, gop_frames=gop_frames,
                              device="cuda")
    bundles = []
    if warm_full:
        warm.plan_override = _live_batch_plan(
            meta.num_frames, gop_frames, warm.num_devices)
        bundles = warm.encode(frames)
    warm.plan_override = _live_batch_plan(gop_frames, gop_frames,
                                          warm.num_devices)
    warm.encode(frames[:gop_frames])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm.encode(frames[:gop_frames])
    edge_fps = gop_frames / (time.perf_counter() - t0)
    ingest_fps = max(0.5, min(float(fps), 0.5 * edge_fps))
    gop_wall_s = gop_frames / max(edge_fps, 1e-3)
    return ingest_fps, max(float(segment_s), 2.0 * gop_wall_s), bundles


def _start_paced_writer(path: str, meta, frames, ingest_fps: float):
    """bench.py's paced writer: a thread appends y4m frames to a growing
    `.live.y4m` at `ingest_fps` and closes the stream with the `.eos`
    marker. Returns (thread, write_times); write_times[i] is the
    monotonic time at which frame i finished reaching the file."""
    import io

    from thinvids_tpu_torch.ingest.tail import EOS_SUFFIX
    from thinvids_tpu_torch.io.y4m import Y4MWriter

    write_times: list[float] = []

    def writer() -> None:
        buf = io.BytesIO()
        wtr = Y4MWriter(buf, meta)
        with open(path, "wb") as out:
            out.write(buf.getvalue())           # header
            out.flush()
            delay = 1.0 / ingest_fps
            next_at = time.monotonic()
            for frame in frames:
                buf.seek(0)
                buf.truncate()
                wtr.write(frame)
                out.write(buf.getvalue())
                out.flush()
                write_times.append(time.monotonic())
                next_at += delay
                time.sleep(max(0.0, next_at - time.monotonic()))
        with open(path + EOS_SUFFIX, "wb"):
            pass

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    return wt, write_times


def _sample_live_edge(running, media: str, write_times, *, nframes: int,
                      gop_frames: int, fps: int, segment_s: float):
    """bench.py's edge sampler: poll the top rung's media playlist while
    `running()`; every newly announced part (one GOP) gives one
    glass-to-playlist sample — from the part's LAST frame reaching the
    source file to the part being listed. Returns (samples, GOPs seen,
    final segments)."""
    import math

    from thinvids_tpu_torch.abr.hls import live_playlist_state

    seg_gops = max(1, math.ceil(segment_s * fps / gop_frames - 1e-9))
    total_gops = -(-nframes // gop_frames)
    samples: list[float] = []
    seen_gops = final_segments = 0
    while True:
        alive = running()
        try:
            with open(media, encoding="utf-8") as fp:
                pl = live_playlist_state(fp.read())
        except OSError:
            pl = None
        if pl is not None:
            now = time.monotonic()
            final_segments = pl["segments"]
            gops = min(total_gops,
                       pl["next_msn"] * seg_gops + pl["next_part"])
            for g in range(seen_gops, gops):
                last_frame = min((g + 1) * gop_frames, nframes) - 1
                if last_frame < len(write_times):
                    samples.append(now - write_times[last_frame])
            seen_gops = max(seen_gops, gops)
        if not alive:
            return samples, seen_gops, final_segments
        time.sleep(0.005)


def live_leg(name: str, frames, w: int, h: int, qp: int, gop: int,
             rungs_spec: str, sfe_bands: int = 0, segment_s: float = 1.0,
             dvr_window_s: float = 2.0) -> dict:
    """bench.py's _run_live point through the port's run_live on the card:
    pace probe, then a paced writer feeding a growing `.live.y4m` in a
    temporary directory, run_live tailing it on a thread, and the edge
    sampler reading the top rung's playlist. The ME launch counts are set
    to 0 just before the live warm-up and read after it, then set to 0
    again and read after run_live returns."""
    import statistics
    import tempfile

    from thinvids_tpu_torch.abr import hls
    from thinvids_tpu_torch.abr.ladder import plan_ladder, rung_segments
    from thinvids_tpu_torch.cluster import executor as texec
    from thinvids_tpu_torch.core.config import DEFAULT_SETTINGS, Settings
    from thinvids_tpu_torch.parallel import dispatch as tdispatch

    t_leg = time.perf_counter()
    fps, n = 30, len(frames)
    meta = VideoMeta(width=w, height=h, fps_num=fps, fps_den=1, num_frames=n)
    snap = Settings(values=dict(
        DEFAULT_SETTINGS, qp=qp, gop_frames=gop, ladder_rungs=rungs_spec,
        segment_s=segment_s, dvr_window_s=dvr_window_s, live_stall_s=10.0,
        sfe_bands=sfe_bands))
    rungs = plan_ladder(meta, snap)
    ingest_fps, segment_s, probe = _measure_live_pace(
        meta, frames, rungs, gop, fps, segment_s, warm_full=True)
    if sfe_bands > 0:
        ingest_fps *= 0.8       # bench: the SFE edge paces below the probe
    snap = Settings(values=dict(snap.values, segment_s=segment_s))
    t_probe = time.perf_counter() - t_leg

    warm = {}
    real_warm = texec.warm_live_shapes

    def counted_warm(enc, meta_, gop_n):
        torch.cuda.synchronize()
        _zero_me_counts()
        real_warm(enc, meta_, gop_n)
        torch.cuda.synchronize()
        warm.update(_me_counts())
        _zero_me_counts()
        with tdispatch._SFE_LAT_LOCK:   # the live run's frames only
            tdispatch._SFE_LAT_MS.clear()

    bundles: list = []
    result: dict = {}
    before = tdispatch.stage_snapshot()
    with tempfile.TemporaryDirectory(prefix="tvt-live-") as tmp:
        path = os.path.join(tmp, f"{name}.live.y4m")
        lib = os.path.join(tmp, "lib")
        media = os.path.join(lib, f"{name}.live.hls", rungs[0].name,
                             hls.MEDIA_PLAYLIST)

        def run() -> None:
            try:
                result.update(texec.run_live(
                    path, lib, snap, device="cuda",
                    on_bundles=bundles.extend))
            except BaseException as exc:    # noqa: BLE001 - re-raised below
                result["error"] = exc

        texec.warm_live_shapes = counted_warm
        try:
            wt, write_times = _start_paced_writer(path, meta, frames,
                                                  ingest_fps)
            job = threading.Thread(target=run, name="tvt-live", daemon=True)
            job.start()
            samples, seen_gops, final_segments = _sample_live_edge(
                job.is_alive, media, write_times, nframes=n,
                gop_frames=gop, fps=fps, segment_s=segment_s)
            job.join()
            wt.join()
        finally:
            texec.warm_live_shapes = real_warm
        torch.cuda.synchronize()
        launches = _me_counts()
        if "error" in result:
            raise result["error"]
        out_dir = os.path.dirname(result["master"])
        if result["segments_gced"] == 0:
            lint = hls.lint_ladder(out_dir, expected_duration_s=n / fps)
        else:
            lint = {r.name: hls.lint_live_media_playlist(os.path.join(
                out_dir, r.name, hls.MEDIA_PLAYLIST))["segments"]
                for r in rungs}
    after = tdispatch.stage_snapshot()
    stage_delta = {k: round(after[k] - before[k], 2) for k in after}
    streams = {r.name: concat_segments(rung_segments(bundles, r.name))
               for r in rungs}
    samples.sort()
    p_frames = n - -(-n // gop)
    fig = {
        "live": name, "rungs": [r.name for r in rungs],
        "latency_s": {"p50": statistics.median(samples) if samples else None,
                      "p99": samples[min(len(samples) - 1,
                                         int(0.99 * len(samples)))]
                      if samples else None},
        "latency_samples": len(samples),
        "ingest_fps": round(ingest_fps, 2), "segment_s": segment_s,
        "dvr_segments": final_segments, "gops": seen_gops,
        "run": {k: result[k] for k in ("gops", "frames", "bytes",
                                       "segments_announced",
                                       "parts_announced", "segments_gced")},
        "warm_launches": warm, "launches": launches,
        "stage_ms": stage_delta,
        "probe_s": round(t_probe, 1),
        "seconds": round(time.perf_counter() - t_leg, 1)}
    if sfe_bands:
        fig["frame_latency_ms"] = tdispatch.frame_latency_percentiles()
    print(f"live leg {json.dumps(fig)}", flush=True)
    print(f"live {name} latency samples s: "
          f"{[round(x, 3) for x in samples]}; lint {json.dumps(lint)}",
          flush=True)
    check(samples, f"live {name}: no part was announced")
    check(result["gops"] == seen_gops == -(-n // gop),
          f"live {name}: {result['gops']} GOPs packaged, {seen_gops} seen")
    want_warm = p_frames // (n // gop) * len(rungs)
    for kname in ("me_halfpel", "me_search"):
        check(warm.get(kname) == want_warm,
              f"live {name}: the warm-up launched {kname} "
              f"{warm.get(kname)} times, want {want_warm}")
        check(launches[kname] == p_frames * len(rungs),
              f"live {name}: {kname} launched {launches[kname]} times, want "
              f"{p_frames * len(rungs)}")
    fig["streams"] = streams
    fig["probe"] = probe
    return fig


def live_phase() -> dict:
    """bench.py's two live points on the card (1920x1080, 48 frames, gop
    8, qp 27): the 1080p + 540p ladder edge and the 4-band split-frame
    edge, each through run_live, each stream against the JAX package's
    (LIVE_POINT_JAX)."""
    from thinvids_tpu_torch.abr.ladder import rung_segments

    w, h, n, gop, qp = 1920, 1080, 48, 8, 27
    frames = make_frames(n, w, h)
    lad = live_leg("ladder", frames, w, h, qp, gop, "540")
    top = lad["streams"]["1080p"]
    low = lad["streams"]["540p"]
    top_sha = hashlib.sha256(top).hexdigest()
    low_sha = hashlib.sha256(low).hexdigest()
    print(f"live ladder streams: 1080p {len(top)} bytes sha256 {top_sha}; "
          f"540p {len(low)} bytes sha256 {low_sha}; 540p equals the JAX "
          f"package's: {[len(low), low_sha] == list(LIVE_POINT_JAX['ladder_540p'])}",
          flush=True)
    check((len(top), top_sha) == tuple(LIVE_POINT_JAX["top_1080p"]),
          f"live ladder: the top rung ({len(top)} bytes, {top_sha}) is not "
          f"the JAX package's {LIVE_POINT_JAX['top_1080p']}")
    batch_low = concat_segments(rung_segments(lad["probe"], "540p"))
    check(low == batch_low,
          "live ladder: the 540p rung differs from the port's batch ladder "
          "over the same frames and pinned grid")
    check(concat_segments(rung_segments(lad["probe"], "1080p")) == top,
          "live ladder: the top rung differs from the batch ladder's")

    sfe = live_leg("sfe", frames, w, h, qp, gop, "1080", sfe_bands=4)
    stream = sfe["streams"]["1080p"]
    sha = hashlib.sha256(stream).hexdigest()
    mbw = (w + 15) // 16
    pics = _slice_firsts(stream)
    print(f"live sfe stream: {len(stream)} bytes sha256 {sha}; slice starts "
          f"of frame 0 {pics[:1]}", flush=True)
    check(len(pics) == n and all(p == [0, 17 * mbw, 34 * mbw, 51 * mbw]
                                 for p in pics),
          f"live sfe: {len(pics)} pictures, slice starts {pics[:1]}")
    check((len(stream), sha) == tuple(LIVE_POINT_JAX["sfe_1080p"]),
          f"live sfe: the stream ({len(stream)} bytes, {sha}) is not the JAX "
          f"package's {LIVE_POINT_JAX['sfe_1080p']}")
    return {"ladder": lad["launches"], "sfe": sfe["launches"]}


# ---- phase 14 ------------------------------------------------------------

def _http(base: str, path: str, body: dict | None = None,
          timeout: float = 10.0) -> tuple[int, bytes]:
    """(status, body bytes) of one request to the daemon's API."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data,
                                 method="POST" if data else "GET")
    if data:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _await_job(base: str, input_path: str, proc, cap_s: float) -> dict:
    """Poll /jobs until the job of `input_path` is done (or failed, or
    `cap_s` passes, or the daemon exits); returns the job's view."""
    deadline = time.monotonic() + cap_s
    while time.monotonic() < deadline:
        check(proc.poll() is None, f"the daemon exited ({proc.returncode})")
        try:
            code, raw = _http(base, "/jobs", timeout=30.0)
        except OSError:         # a busy daemon may answer late: ask again
            continue
        if code == 200:
            for job in json.loads(raw)["jobs"]:
                if job["input_path"] == input_path and \
                        job["status"] in ("done", "failed", "rejected"):
                    check(job["status"] == "done",
                          f"manager job {input_path}: {job['status']} "
                          f"({job.get('failure_reason')})")
                    return job
        time.sleep(0.2)
    raise RuntimeError(f"check failed: manager job {input_path} not done "
                       f"within {cap_s:.0f} s")


def _trace_kernel_launches(trace_dir: str) -> dict:
    """Launches of each ME kernel in the torch.profiler Chrome trace(s)
    the daemon wrote for one job."""
    counts = {"me_halfpel": 0, "me_search": 0}
    kernels = {"me_halfpel": "halfpel_kernel", "me_search": "search_kernel"}
    files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    check(files, f"no profiler trace under {trace_dir}")
    for path in files:
        with open(path, encoding="utf-8") as fp:
            events = json.load(fp)["traceEvents"]
        for e in events:
            if e.get("cat") != "kernel":
                continue
            for key, name in kernels.items():
                if name in e.get("name", ""):
                    counts[key] += 1
    return counts


def manager_phase(want_mp4: bytes, want_tree: dict, card: str,
                  w: int = 1920, h: int = 1080, n: int = 16, gop: int = 8,
                  qp: int = 27, device: str = "cuda") -> dict:
    """The manager node in a subprocess, driven over its HTTP API and its
    watch folder (phase 14 above). Returns the ME launches the transcode
    job's profiler trace holds."""
    import signal
    import socket
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="tvt-manager-") as tmp:
        dirs = {k: os.path.join(tmp, k) for k in
                ("watch", "library", "state", "profile", "inputs")}
        for d in dirs.values():
            os.makedirs(d)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        base = f"http://127.0.0.1:{port}"
        env = dict(os.environ, PYTHONPATH=root, TVT_MIN_IDLE_WORKERS="0",
                   TVT_GOP_FRAMES=str(gop), TVT_QP=str(qp),
                   TVT_PROFILE_DIR=dirs["profile"])
        log_path = os.path.join(tmp, "coordinator.log")
        t0 = time.perf_counter()
        with open(log_path, "wb") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "thinvids_tpu_torch.cli",
                 "coordinator", "--host", "127.0.0.1", "--port", str(port),
                 "--state-dir", dirs["state"], "--watch-dir", dirs["watch"],
                 "--output-dir", dirs["library"], "--scan-interval", "0.5",
                 "--device", device],
                cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
        ok = False
        try:
            while not _http_up(base):
                check(proc.poll() is None,
                      f"the daemon exited ({proc.returncode})")
                check(time.perf_counter() - t0 < 120,
                      "the daemon's API did not come up within 120 s")
                time.sleep(0.1)
            t_up = time.perf_counter() - t0
            print(f"manager daemon up in {t_up:.3f} s (Popen to /health) "
                  f"on {card}", flush=True)

            # transcode: phase 6's clip dropped into the watch folder
            staged = os.path.join(dirs["inputs"], "job1080.y4m")
            _write_clip(staged, make_frames(n, w, h), w, h)
            dropped = os.path.join(dirs["watch"], "job1080.y4m")
            t_drop = time.perf_counter()
            os.replace(staged, dropped)
            job = _await_job(base, dropped, proc, 120.0)
            t_seen = time.perf_counter() - t_drop
            with open(job["output_path"], "rb") as fp:
                mp4 = fp.read()
            trace_dir = os.path.join(dirs["profile"], f"job-{job['id'][:8]}")
            launches = _trace_kernel_launches(trace_dir)
            run_s = job["finished_at"] - job["started_at"]
            print(f"manager transcode {w}x{h} x{n}: MP4 {len(mp4)} bytes, "
                  f"sha256 {hashlib.sha256(mp4).hexdigest()}; submit to "
                  f"done {job['finished_at'] - job['created_at']:.3f} s, "
                  f"run {run_s:.3f} s ({n / run_s:.3f} job fps, profiled), "
                  f"drop to done seen {t_seen:.3f} s; trace launches "
                  f"{json.dumps(launches)}; {card}", flush=True)
            check(mp4 == want_mp4, "the manager's MP4 differs from phase 6's")
            # (the CPU runs the kernels' plain versions: no launch to count)
            for name, count in launches.items() if device == "cuda" else ():
                check(count == n - -(-n // gop),
                      f"manager transcode: the trace holds {count} "
                      f"{name} launches, want {n - -(-n // gop)}")

            # the same transcode posted to /add_job without the profiler:
            # the job fps an operator sees
            upath = os.path.join(dirs["inputs"], "job1080_plain.y4m")
            _write_clip(upath, make_frames(n, w, h), w, h)
            code, raw = _http(base, "/add_job", {
                "input_path": upath, "settings": {"profile_dir": ""}})
            check(code == 201, f"/add_job answered {code}: {raw[:200]!r}")
            ujob = _await_job(base, upath, proc, 120.0)
            with open(ujob["output_path"], "rb") as fp:
                check(fp.read() == want_mp4,
                      "the manager's unprofiled MP4 differs from phase 6's")
            urun = ujob["finished_at"] - ujob["started_at"]
            print(f"manager transcode, not profiled: submit to done "
                  f"{ujob['finished_at'] - ujob['created_at']:.3f} s, run "
                  f"{urun:.3f} s ({n / urun:.3f} job fps); {card}",
                  flush=True)
            check(not os.path.exists(os.path.join(
                dirs["profile"], f"job-{ujob['id'][:8]}")),
                "the job's profile_dir override was not honoured")

            # ladder: phase 12's job through /add_job, served by the origin
            lpath = os.path.join(dirs["inputs"], "ladder1080.ladder.y4m")
            _write_clip(lpath, make_frames(n, w, h), w, h)
            t_post = time.perf_counter()
            code, raw = _http(base, "/add_job", {
                "input_path": lpath, "settings": {"profile_dir": ""}})
            check(code == 201, f"/add_job answered {code}: {raw[:200]!r}")
            ljob = _await_job(base, lpath, proc, 120.0)
            t_lseen = time.perf_counter() - t_post
            tree = tree_digest(os.path.dirname(ljob["output_path"]))
            lrun = ljob["finished_at"] - ljob["started_at"]
            print(f"manager ladder {w}x{h} x{n}: {len(tree)} files, "
                  f"{sum(v[0] for v in tree.values())} bytes; submit to done "
                  f"{ljob['finished_at'] - ljob['created_at']:.3f} s, run "
                  f"{lrun:.3f} s ({n / lrun:.3f} job fps), post to done seen "
                  f"{t_lseen:.3f} s; {card}", flush=True)
            check(tree == want_tree,
                  "the manager's ladder tree differs from phase 12's: "
                  f"{sorted(set(tree.items()) ^ set(want_tree.items()))[:4]}")
            code, master = _http(base, f"/hls/{ljob['id']}/master.m3u8")
            with open(ljob["output_path"], "rb") as fp:
                check(code == 200 and master == fp.read(),
                      f"the origin served the master playlist with {code}")

            # the node agent and the port's stage totals
            time.sleep(1.5)         # one agent tick past both jobs
            code, raw = _http(base, "/metrics_snapshot")
            check(code == 200, f"/metrics_snapshot answered {code}")
            snap = json.loads(raw)
            rows = list(snap["metrics"].values())
            kind = (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu")
            node = [m for m in rows if m.get("devices") == 1
                    and m.get("device_kind") == kind]
            print(f"manager agent rows "
                  f"{json.dumps([{k: m.get(k) for k in ('devices', 'device_kind', 'hbm_used_bytes', 'hbm_total_bytes', 'hbm_pct')} for m in rows])}"
                  f"; stage_ms {json.dumps(snap['stage_ms'])}", flush=True)
            check(node, f"no node row reports 1 device of kind {kind!r}")
            if device == "cuda":
                check(all(m.get("hbm_total_bytes", 0) > 0 for m in node),
                      "the node row reports no card memory")
            check(snap["stage_ms"].get("waves", 0) > 0,
                  "/metrics_snapshot carries no port stage totals")
            ok = True
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=40)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=20)
            with open(log_path, "rb") as fp:
                tail = fp.read()[-(2000 if ok else 6000):]
            print("manager daemon log (tail):\n"
                  + tail.decode(errors="replace"), flush=True)
    return launches


def _http_up(base: str) -> bool:
    """True once the daemon answers /health."""
    try:
        return _http(base, "/health", timeout=2.0)[0] == 200
    except OSError:
        return False


# ---- phase 16 ------------------------------------------------------------

def _http_delete(base: str, path: str) -> int:
    import urllib.request

    req = urllib.request.Request(base + path, method="DELETE")
    with urllib.request.urlopen(req, timeout=10.0) as resp:
        return resp.status


def _active_hosts(base: str) -> set:
    """Hosts the coordinator counts as live (registry row within its TTL)."""
    code, raw = _http(base, "/nodes_data")
    check(code == 200, f"/nodes_data answered {code}")
    return {n["host"] for n in json.loads(raw)["nodes"] if n["active"]}


def _await_hosts(base: str, hosts: set, proc, cap_s: float) -> float:
    """Seconds until every host of `hosts` is live at the coordinator."""
    t0 = time.perf_counter()
    while not hosts <= _active_hosts(base):
        check(proc.poll() is None, f"the daemon exited ({proc.returncode})")
        check(time.perf_counter() - t0 < cap_s,
              f"workers {sorted(hosts)} not live within {cap_s:.0f} s")
        time.sleep(0.1)
    return time.perf_counter() - t0


@contextlib.contextmanager
def _remote_daemon(tmp: str, card: str, device: str, gop: int, qp: int,
                   workers=()):
    """`cli coordinator --backend remote` (watch folder, library, state
    dir in `tmp`; 1-GOP shards, gop `gop`, qp `qp`, a 3 s heartbeat TTL)
    and a `cli worker` process for each host of `workers`, all live.
    Yields (base URL, the coordinator's process, the dirs, the processes
    in start order); stops every process it started, printing each log's
    tail."""
    import signal
    import socket

    root = os.path.dirname(os.path.abspath(__file__))
    procs: list = []
    dirs = {k: os.path.join(tmp, k) for k in
            ("watch", "library", "state", "inputs", "logs")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=root, TVT_MIN_IDLE_WORKERS="0",
               TVT_GOP_FRAMES=str(gop), TVT_QP=str(qp),
               TVT_REMOTE_SHARD_GOPS="1", TVT_METRICS_TTL_S="3",
               TVT_REMOTE_RETRY_BACKOFF_S="0.2",
               TVT_SCHEDULER_POLL_S="0.5")

    def spawn(name: str, args: list):
        log = open(os.path.join(dirs["logs"], f"{name}.log"), "wb")
        proc = subprocess.Popen(
            [sys.executable, "-m", "thinvids_tpu_torch.cli", *args],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
        log.close()
        procs.append((name, proc))
        return proc

    ok = False
    try:
        t0 = time.perf_counter()
        coord = spawn("coordinator", [
            "coordinator", "--backend", "remote", "--device", device,
            "--host", "127.0.0.1", "--port", str(port),
            "--state-dir", dirs["state"], "--watch-dir", dirs["watch"],
            "--output-dir", dirs["library"], "--scan-interval", "0.5"])
        for host in workers:
            spawn(host, ["worker", "--device", device, "--coordinator",
                         base, "--node-name", host, "--interval", "0.3",
                         "--poll", "0.2"])
        while not _http_up(base):
            check(coord.poll() is None,
                  f"the daemon exited ({coord.returncode})")
            check(time.perf_counter() - t0 < 120,
                  "the daemon's API did not come up within 120 s")
            time.sleep(0.1)
        t_up = time.perf_counter() - t0
        t_workers = t_up + _await_hosts(base, set(workers), coord, 120.0)
        print(f"farm daemon up in {t_up:.3f} s, {len(workers)} worker "
              f"processes live in {t_workers:.3f} s (Popen to /nodes_data) "
              f"on {card}", flush=True)
        yield base, coord, dirs, procs
        ok = True
    finally:
        for _name, proc in reversed(procs):
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for name, proc in reversed(procs):
            try:
                proc.wait(timeout=40)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=20)
            with open(os.path.join(dirs["logs"], f"{name}.log"),
                      "rb") as fp:
                tail = fp.read()[-(800 if ok else 4000):]
            print(f"farm {name} log (tail):\n"
                  + tail.decode(errors="replace"), flush=True)


@contextlib.contextmanager
def _worker_threads(base: str, coord, meshes: dict, device: str):
    """One in-process WorkerDaemon thread (with its node agent) for each
    host of `meshes` (host → its DeviceMesh, or None for the one
    `device`), live at the coordinator; all stopped on exit. In this
    process the kernels' launch counts see their work."""
    from thinvids_tpu_torch.cluster.agent import NodeAgent, http_submitter
    from thinvids_tpu_torch.cluster.remote import WorkerDaemon

    stop = threading.Event()
    agents: list = []
    loops: list = []
    try:
        for host, mesh in meshes.items():
            daemon = WorkerDaemon(base, host=host, poll_s=0.1,
                                  device=device, mesh=mesh)
            agents.append(NodeAgent(
                http_submitter(base), host=host, interval_s=0.3,
                extra_metrics=daemon.metrics, device=device).start())
            loops.append(threading.Thread(
                target=daemon.run_forever, args=(stop,), daemon=True,
                name=f"tvt-{host}"))
            loops[-1].start()
        _await_hosts(base, set(meshes), coord, 60.0)
        # the band planner reads each worker's advertised devices
        want = {h: m.size if m is not None else 1 for h, m in meshes.items()}
        deadline = time.perf_counter() + 30.0
        while True:
            rows = json.loads(_http(base, "/metrics_snapshot")[1])["metrics"]
            got = {h: rows.get(h, {}).get("worker_devices") for h in want}
            if got == want:
                break
            check(time.perf_counter() < deadline,
                  f"workers advertise {got} devices, want {want}")
            time.sleep(0.1)
        yield
    finally:
        stop.set()
        for agent in agents:
            agent.stop()
        for loop in loops:
            loop.join(timeout=30)


def _farm_sfe_job(base: str, coord, path: str, bands: int, halo: int,
                  device: str) -> dict:
    """A farm SFE job of `path` posted to /add_job (sfe_bands `bands`,
    halo `halo`) with every ME launch count set to 0 just before and read
    just after: the MP4, the job's view, the launches (totals and by card
    index), the workers' stage_ms delta and the per-frame latency."""
    from thinvids_tpu_torch.parallel import dispatch

    before = dispatch.stage_snapshot()
    with dispatch._SFE_LAT_LOCK:
        dispatch._SFE_LAT_MS.clear()
    if device == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    torchme.reset_launch_counts()
    code, raw = _http(base, "/add_job", {
        "input_path": path,
        "settings": {"sfe_bands": bands, "sfe_halo_rows": halo}})
    check(code == 201, f"/add_job answered {code}: {raw[:200]!r}")
    job = _await_job(base, path, coord, 300.0)
    launches, by_card = _me_counts(), _by_device()
    after = dispatch.stage_snapshot()
    with open(job["output_path"], "rb") as fp:
        mp4 = fp.read()
    return {"mp4": mp4, "job": job, "launches": launches,
            "by_card": by_card,
            "run_s": job["finished_at"] - job["started_at"],
            "stage_ms": {k: round(after[k] - before[k], 2) for k in
                         ("halo", "dispatch", "device_wait", "fetch", "sfe",
                          "stage", "decode", "sfe_frames",
                          "dense_fallback_waves")},
            "latency": dispatch.frame_latency_percentiles()}


def farm_phase(want_mp4: bytes, card: str, w: int = 3840, h: int = 2160,
               n: int = 16, gop: int = 8, qp: int = 27, halo: int = 32,
               want_farm: tuple = FARM_POINT_JAX,
               gop_size: tuple = (1920, 1080), device: str = "cuda") -> dict:
    """The remote backend and the farm on the card (phase 16 above): a
    remote coordinator daemon, two worker daemon processes for a GOP job
    (phase 6's clip, `gop_size`), then two in-process WorkerDaemon
    threads for a two-slice farm SFE job at 4K. Returns each ME kernel's
    launches in the farm SFE run, its fps, stage totals and per-frame
    latency."""
    import signal
    import tempfile

    from thinvids_tpu_torch.ingest.decode import open_video
    from thinvids_tpu_torch.io.mp4 import mux_mp4

    hosts = [f"farm-w{i}" for i in range(2)]
    with tempfile.TemporaryDirectory(prefix="tvt-farm-") as tmp, \
            _remote_daemon(tmp, card, device, gop, qp, hosts) as (
                base, coord, dirs, procs):
        # (a) a remote GOP job: phase 6's clip through the watch folder
        gw, gh = gop_size
        staged = os.path.join(dirs["inputs"], "farm_gop.y4m")
        _write_clip(staged, make_frames(16, gw, gh), gw, gh)
        dropped = os.path.join(dirs["watch"], "farm_gop.y4m")
        os.replace(staged, dropped)
        job = _await_job(base, dropped, coord, 180.0)
        with open(job["output_path"], "rb") as fp:
            mp4 = fp.read()
        deadline = time.perf_counter() + 10.0
        while True:     # the shard counters ride the next heartbeat
            code, raw = _http(base, "/metrics_snapshot")
            check(code == 200, f"/metrics_snapshot answered {code}")
            rows = json.loads(raw)["metrics"]
            done = {host: rows.get(host, {}).get("worker_shards_done", 0)
                    for host in hosts}
            if sum(done.values()) >= 2 or time.perf_counter() > deadline:
                break
            time.sleep(0.2)
        run_s = job["finished_at"] - job["started_at"]
        print(f"farm GOP job {gw}x{gh} x16 gop {gop} qp {qp}, 1-GOP "
              f"shards: "
              f"MP4 {len(mp4)} bytes, sha256 "
              f"{hashlib.sha256(mp4).hexdigest()}; shards done "
              f"{json.dumps(done)}; submit to done "
              f"{job['finished_at'] - job['created_at']:.3f} s, run "
              f"{run_s:.3f} s ({16 / run_s:.3f} job fps); {card}",
              flush=True)
        check(mp4 == want_mp4, "the farm's MP4 differs from phase 6's")
        check(all(v >= 1 for v in done.values()),
              f"a worker took no shard: {done}")
        for name, proc in procs[1:]:
            proc.send_signal(signal.SIGTERM)
        for name, proc in procs[1:]:
            proc.wait(timeout=30)
            check(_http_delete(base, f"/nodes/delete/{name}") == 200,
                  f"the registry kept {name}")

        # (b) farm SFE at 4K: two slices of a 2-band layout on two
        # WorkerDaemon threads of this process, over the relay
        frames = make_frames(n, w, h)
        path = os.path.join(dirs["inputs"], "farm2160.y4m")
        _write_clip(path, frames, w, h)
        with open_video(path) as src:
            meta = src.meta
        local = _sfe_encoder(meta, qp, gop, 2, halo, device=device)
        t_l = time.perf_counter()
        stream = concat_segments(local.encode(frames))
        t_l = time.perf_counter() - t_l
        digest = hashlib.sha256(stream).hexdigest()
        print(f"farm point, local 2-band SfeShardEncoder {w}x{h} x{n}: "
              f"{len(stream)} bytes, sha256 {digest} ({n / t_l:.3f} fps "
              "through encode())", flush=True)
        check((len(stream), digest) == want_farm,
              f"the local 2-band stream ({len(stream)}, {digest}) is not "
              f"the JAX package's {want_farm}")
        del local, frames
        threads = {f"farm-t{i}": None for i in range(2)}
        with _worker_threads(base, coord, threads, device):
            check(not (_active_hosts(base) & set(hosts)),
                  "a worker process is still live")
            run = _farm_sfe_job(base, coord, path, 2, halo, device)
        fjob, fmp4, frun = run["job"], run["mp4"], run["run_s"]
        launches, delta, lat = run["launches"], run["stage_ms"], \
            run["latency"]
        print(f"farm SFE job {w}x{h} x{n} gop {gop} qp {qp}, 2 slices "
              f"of 1 band, halo {halo}: MP4 {len(fmp4)} bytes, sha256 "
              f"{hashlib.sha256(fmp4).hexdigest()}; submit to done "
              f"{fjob['finished_at'] - fjob['created_at']:.3f} s, run "
              f"{frun:.3f} s ({n / frun:.3f} fps); ME launches "
              f"{launches}; stage_ms (both workers) {json.dumps(delta)}; "
              f"per-frame latency {json.dumps(lat)}; {card}",
              flush=True)
        check(fmp4 == mux_mp4(stream, meta),
              "the farm's SFE MP4 differs from the local 2-band "
              "stream's")
        p_frames = n - -(-n // gop)
        # (the CPU runs the kernels' plain versions: no launch to count)
        for name, count in launches.items() if device == "cuda" else ():
            check(count == 2 * p_frames,
                  f"farm SFE: {name} launched {count} times, want "
                  f"{2 * p_frames} (each worker once per P frame)")
        check(delta["dense_fallback_waves"] == 0,
              "the farm SFE run replayed dense")
    return {"launches": launches, "fps": round(n / frun, 3),
            "stage_ms": delta, "latency": lat}


# ---- phase 17 ------------------------------------------------------------

def _mesh():
    """The first 4 cards when the machine has four or more, else the
    first 2 when it has two or more, else two entries on cuda:0
    (aliased: the mesh path runs, but no two cards share the work). The
    GOP plan rounds 17a's 4 GOPs up to the mesh width, so only a width
    that divides 4 plans the GOPs that MESH_POINT_JAX (two devices)
    recorded."""
    from thinvids_tpu_torch.core.devices import DeviceMesh

    cards = torch.cuda.device_count()
    width = 4 if cards >= 4 else 2
    mesh = DeviceMesh([f"cuda:{i if cards >= 2 else 0}"
                       for i in range(width)])
    note = "" if mesh.distinct_cards > 1 else \
        " (aliased: both entries on cuda:0, no multi-card measurement)"
    tag = f"mesh: {mesh.size} entries on {mesh.distinct_cards} distinct " \
          f"cards of the {cards} visible{note}"
    print(tag, flush=True)
    return mesh, tag


def _sync_all(mesh) -> None:
    for d in sorted({d.index for d in mesh.devices}):
        torch.cuda.synchronize(d)


def _by_device() -> dict:
    return {"me_halfpel": dict(torchme.ME_PREPASS_LAUNCHES_BY_DEVICE),
            "me_search": dict(torchme.ME_KERNEL_LAUNCHES_BY_DEVICE)}


def _check_by_device(what: str, got: dict, want: dict) -> None:
    for name, counts in got.items():
        check(counts == want, f"{what}: {name} launched {counts} times by "
                              f"card index, want {want}")


def _per_card(mesh, per_entry: list) -> dict:
    out: dict = {}
    for dev, n in zip(mesh.devices, per_entry):
        out[dev.index] = out.get(dev.index, 0) + n
    return out


def mesh_run_kernels(mesh, tag: str) -> dict:
    """Both kernels on the stacks the mesh's entries hand them at the 4K
    split-frame point: 4 bands of 608 rows (halo 32) split into one run
    an entry (dispatch._runs), each entry's (n, 608, 3840) run with the
    runs beside it injected at its inner edges (torchme.extend_bands
    with `ext`), one launch each on the entry's card against the plain
    version, bit-exactly; then an inner run's time on its card (the
    second entry's: rows injected above it, and below it too on more
    than two entries) beside the bound over its planes."""
    from thinvids_tpu_torch.parallel.dispatch import _runs

    h, w, bands, halo = 2176, 3840, 4, 32
    Hb = h // bands
    cur, ref, ru, rv = (torch.from_numpy(a.astype(np.int16))
                        for a in _me_inputs("pan", h, w, 6))
    err = {"me_halfpel": 0, "me_search": 0}
    offs = np.cumsum([0] + _runs(bands, mesh.size)).tolist()
    runs = list(zip(offs[:-1], offs[1:]))
    checked = []
    timed = None
    for r, (b0, b1) in enumerate(runs):
        dev = mesh.devices[r]
        with torch.cuda.device(dev):
            y0, y1 = b0 * Hb, b1 * Hb
            edge_top, edge_bot = b0 == 0, b1 == bands

            def part(p, d):
                return p[y0 // d:y1 // d].reshape(b1 - b0, Hb // d,
                                                  p.shape[1]).to(dev)

            def edge(p, d):
                k = halo // d
                return (None if edge_top else p[y0 // d - k:y0 // d].to(dev),
                        None if edge_bot else p[y1 // d:y1 // d + k].to(dev))

            ext = edge(ref, 1) + edge(ru, 2) + edge(rv, 2)
            stacks = torchme.extend_bands(part(cur, 1), part(ref, 1),
                                          part(ru, 2), part(rv, 2), halo,
                                          ext=ext, edge_top=edge_top,
                                          edge_bot=edge_bot)
            check(tuple(stacks[0].shape) == (b1 - b0, Hb + 2 * halo, w),
                  f"mesh run stack {tuple(stacks[0].shape)}")
            centers = torchme.banded_centers_from(
                part(cur, 1), part(ref, 1),
                torch.tensor([4, -6], dtype=torch.int32, device=dev),
                (Hb,) * (b1 - b0), halo)
            lam = torchme.lambda_for(27, dev)
            planes = torchme.halfpel_planes_cuda(stacks[1])
            got = torchme.me_search_cuda(*stacks, centers, lam)
            torch.cuda.synchronize(dev)
            e = int((planes.to(torch.int32) - torchme.halfpel_planes_ref(
                stacks[1]).to(torch.int32)).abs().max())
            err["me_halfpel"] = max(err["me_halfpel"], e)
            want = torchme.me_search_ref(*stacks, centers, lam)
            for name, a, b in zip(("mv", "pred_y", "pred_u", "pred_v"),
                                  got, want):
                e = int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
                err["me_search"] = max(err["me_search"], e)
                check(a.shape == b.shape and e == 0,
                      f"mesh run {r}: {name} differs (max |diff| {e})")
            checked.append(f"entry {r} bands [{b0}, {b1}) on {dev}")
            if r == min(1, len(runs) - 1):
                timed = (stacks, centers, lam)
    check(err["me_halfpel"] == 0,
          f"mesh run planes differ (max |diff| {err['me_halfpel']})")
    stacks, centers, lam = timed
    B, He, W = stacks[0].shape
    planes = torchme.halfpel_planes_cuda(stacks[1])
    fns = {"me_halfpel": lambda: torchme.halfpel_planes_cuda(stacks[1]),
           "me_search": lambda: torchme.me_search_planes_cuda(
               stacks[0], planes, stacks[2], stacks[3], centers, lam)}
    plain = {"me_halfpel": _median_ms(
        lambda: torchme.halfpel_planes_ref(stacks[1]), reps=3),
        "me_search": _median_ms(lambda: torchme.me_search_ref(
            *stacks, centers, lam), reps=3)}
    bounds = me_bounds(He, W, B)
    print(f"mesh runs bit-exact against the plain version: "
          f"{'; '.join(checked)}; {tag}", flush=True)
    out = {}
    with torch.cuda.device(stacks[0].device):
        for name, fn in fns.items():
            ms = min(_graph_ms(fn) for _ in range(2))
            ops, nbytes = bounds[name]
            bound_ms, bound_by = _bound(ops, nbytes)
            print(f"{name} mesh run {B}x{He}x{W} on {stacks[0].device} "
                  f"(entry {min(1, len(runs) - 1)}'s run, the runs beside "
                  f"it injected): {ms:.4f} ms a launch (CUDA graph of 50, "
                  f"best of 2 medians of 5), plain {plain[name]:.3f} ms, "
                  f"bound {bound_ms:.4f} ms by {bound_by}, "
                  f"{100 * bound_ms / ms:.1f}% of bound; {tag}", flush=True)
            out[name] = {"shape": [B, He, W], "max_abs_err": err[name],
                         "ms": ms, "plain_ms": plain[name],
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": None}
    return out


def mesh_gop_point(mesh, tag: str, main: dict, w: int = 1920,
                   h: int = 1080, n: int = 16, gop: int = 4,
                   qp: int = 27) -> dict:
    """Phase 17a: bench's 1080p content through GopShardEncoder on the
    mesh; the stream against the JAX package's on two devices, the
    launches per card, and e2e fps (pre-staged waves, best of 2) beside
    the same point on one entry, timed in this phase."""
    from thinvids_tpu_torch.parallel.dispatch import _runs

    frames = make_frames(n, w, h)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    enc = GopShardEncoder(meta, qp=qp, gop_frames=gop, mesh=mesh)
    concat_segments(enc.encode(frames))          # warm-up pass
    _sync_all(mesh)
    torchme.reset_launch_counts()
    enc.stages.reset()
    t0 = time.perf_counter()
    stream = concat_segments(enc.encode(frames))
    t_cold = time.perf_counter() - t0
    by_dev = _by_device()
    digest = hashlib.sha256(stream).hexdigest()
    snap = enc.stages.snapshot()
    plan = enc.plan(n)
    # each wave's GOPs split into contiguous runs, one an entry
    per_entry = [0] * mesh.size
    per_wave = mesh.size * enc.gops_per_wave
    gops = list(plan.gops)
    for a in range(0, len(gops), per_wave):
        wave = gops[a:a + per_wave]
        full = wave + [wave[-1]] * ((-len(wave)) % mesh.size)
        i = 0
        for e, k in enumerate(_runs(len(full), mesh.size)):
            per_entry[e] += sum(g.num_frames - 1 for g in full[i:i + k])
            i += k
    want = _per_card(mesh, per_entry)
    print(f"mesh gop point {w}x{h} x{n} gop {gop} qp {qp}: {len(stream)} "
          f"bytes, sha256 {digest}, {n / t_cold:.3f} fps through encode() "
          f"(staging included), ME launches by card index {by_dev} (per "
          f"entry {per_entry}), fetch_shards {snap['fetch_shards']}; {tag}",
          flush=True)
    check((len(stream), digest) == MESH_POINT_JAX,
          f"mesh point: the stream ({len(stream)} bytes, {digest}) is not "
          f"the JAX package's on two devices {MESH_POINT_JAX}")
    check(sum(per_entry) == n - plan.num_gops,
          f"per-entry P frames {per_entry}")
    _check_by_device("mesh gop point", by_dev, want)

    one = GopShardEncoder(meta, qp=qp, gop_frames=gop,
                          device=mesh.devices[0])
    figs = {}
    for name, e in (("mesh", enc), ("one entry", one)):
        _, waves = e.prepare_waves(frames)
        concat_segments(e.encode_waves(waves))
        _sync_all(mesh)
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            s2 = concat_segments(e.encode_waves(waves))
            best = min(best, time.perf_counter() - t0)
            if name == "mesh":
                check(s2 == stream, "a repeated mesh encode changed bytes")
        figs[name] = round(n / best, 3)
    print(f"mesh gop point e2e fps (pre-staged waves, best of 2): "
          f"{json.dumps(figs)}; phase 4 (one card, gop 8) e2e "
          f"{main.get('e2e_fps')} fps; {tag}; card {card_line()}",
          flush=True)
    return {"launches_by_device": by_dev, "per_entry": per_entry,
            "fps": figs}


def mesh_sfe_point(mesh, tag: str, sfe: dict, w: int = 3840,
                   h: int = 2160, n: int = 16, gop: int = 8, qp: int = 27,
                   bands: int = 4, halo: int = 32) -> dict:
    """Phase 17b: bench's 4K split-frame point with its 4 bands spread
    over the mesh; the stream against phase 10's (the JAX package's),
    each ME kernel once per P frame per entry, and fps, the IDR step's
    seconds and the per-frame latency p50 / p99 beside phase 10's."""
    import statistics

    from thinvids_tpu_torch.parallel.dispatch import SfeShardEncoder

    frames = make_frames(n, w, h)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    enc = SfeShardEncoder(meta, qp=qp, gop_frames=gop, bands=bands,
                          halo_rows=halo, mesh=mesh)
    entries = enc.num_devices
    _, waves = enc.prepare_waves(frames)
    concat_segments(enc.encode_waves(waves[:1]))         # warm-up GOP
    _sync_all(mesh)
    torchme.reset_launch_counts()
    enc.stages.reset()
    t0 = time.perf_counter()
    stream = concat_segments(enc.encode(frames))
    t_enc = time.perf_counter() - t0
    by_dev = _by_device()
    digest = hashlib.sha256(stream).hexdigest()
    p_frames = n - len(enc.plan(n).gops)
    want = _per_card(enc.mesh, [p_frames] * entries)
    print(f"mesh sfe point {w}x{h} x{n} gop {gop} bands {bands} on "
          f"{entries} entries (runs {list(enc._band_runs)}): {len(stream)} "
          f"bytes, sha256 {digest}, {n / t_enc:.3f} fps through encode(), "
          f"ME launches by card index {by_dev}; {tag}", flush=True)
    check((len(stream), digest) == SFE_POINT_JAX["bench_2160p"],
          f"mesh SFE point: the stream ({len(stream)}, {digest}) is not "
          f"phase 10's {SFE_POINT_JAX['bench_2160p']}")
    _check_by_device("mesh SFE point", by_dev, want)

    runs, t_best, lat = 0, float("inf"), []
    while runs < 1:
        enc.frame_done_t.clear()
        t0 = time.perf_counter()
        s2 = concat_segments(enc.encode_waves(waves))
        t = time.perf_counter() - t0
        runs += 1
        check(s2 == stream, "a repeated mesh SFE pass changed the bytes")
        if t < t_best:
            t_best, lat = t, enc.frame_latencies_ms()
    _, ys, us, vs, _ = waves[0]

    def idr():
        list(enc._walk(1, ys, us, vs, qp))
        _sync_all(mesh)

    idr_ms = min(_timed_ms(idr) for _ in range(2))
    if not sfe:
        sfe = _one_entry_sfe(meta, frames, qp, gop, bands, halo,
                             mesh.devices[0])
    lat_sorted = sorted(lat) or [0.0]
    fig = {"fps": round(n / t_best, 3),
           "latency_ms_p50": round(statistics.median(lat_sorted), 3),
           "latency_ms_p99": round(
               lat_sorted[int(0.99 * (len(lat_sorted) - 1))], 3),
           "idr_step_ms": round(idr_ms, 3), "entries": entries}
    print(f"mesh sfe figures ({runs} timed pass over pre-staged waves): "
          f"{json.dumps(fig)}; one card (phase 10, or this call): "
          f"{json.dumps(sfe.get('fig', {}))}, idr_step_ms "
          f"{sfe.get('idr_step_ms')}; {tag}; card {card_line()}",
          flush=True)
    return {"launches_by_device": by_dev, "per_entry": [p_frames] * entries,
            "fig": fig, "stream": stream}


def _one_entry_sfe(meta, frames, qp: int, gop: int, bands: int,
                   halo: int, dev) -> dict:
    """Phase 10's figures at the same point on one entry, for a call that
    runs phase 17 alone: one timed pass after a warm-up GOP, and the
    banded IDR step's host-clock seconds."""
    import statistics

    enc = _sfe_encoder(meta, qp, gop, bands, halo, device=dev)
    _, waves = enc.prepare_waves(frames)
    concat_segments(enc.encode_waves(waves[:1]))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    concat_segments(enc.encode_waves(waves))
    t = time.perf_counter() - t0
    lat = sorted(enc.frame_latencies_ms()) or [0.0]
    _, ys, us, vs, _ = waves[0]
    idr = _sync_ms(lambda: enc._intra_step(ys[0], us[0], vs[0], qp), reps=2)
    return {"fig": {"fps": round(len(frames) / t, 3),
                    "latency_ms_p50": round(statistics.median(lat), 3),
                    "latency_ms_p99": round(
                        lat[int(0.99 * (len(lat) - 1))], 3)},
            "idr_step_ms": round(idr, 3)}


def _timed_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _farm_meshes() -> tuple[dict, str]:
    """Phase 17d's two workers and their meshes: cuda:0,1 and cuda:2,3
    when the machine has four cards or more, else cuda:0 twice each
    (aliased: the path runs, but no two cards share the work)."""
    from thinvids_tpu_torch.core.devices import DeviceMesh

    cards = torch.cuda.device_count()
    pairs = (("cuda:0", "cuda:1"), ("cuda:2", "cuda:3")) if cards >= 4 \
        else (("cuda:0", "cuda:0"),) * 2
    meshes = {f"mesh-farm-w{i}": DeviceMesh(p) for i, p in enumerate(pairs)}
    distinct = len({d for p in pairs for d in p})
    tag = (f"farm workers' meshes {[list(p) for p in pairs]}: {distinct} "
           f"distinct cards of the {cards} visible"
           + ("" if distinct == 4 else
              " (aliased: the path, not a measurement)"))
    return meshes, tag


def mesh_farm_point(card: str, farm: dict, stream: bytes | None = None,
                    w: int = 3840, h: int = 2160, n: int = 16, gop: int = 8,
                    qp: int = 27, halo: int = 32, bands: int = 4,
                    device: str = "cuda") -> dict:
    """Phase 17d: bench's 4K split-frame point as a farm SFE job of
    `bands` bands through the remote coordinator daemon, taken by two
    in-process WorkerDaemon threads, each on a two-entry mesh: a 2-band
    slice a worker, one band a run. First both kernels at those runs'
    stacks (check_farm_slice_kernels over the 4-band layout). The MP4
    must be the mux of `stream` (phase 17b's 4-band stream, or a local
    one-card encode when None), whose length and sha256 are the JAX
    package's (SFE_POINT_JAX); each kernel launched once per P frame per
    entry, counted by card. Prints fps, the workers' stage_ms and the
    per-frame gap p50 / p99 beside phase 16's 2-band farm (`farm`)."""
    import tempfile

    from thinvids_tpu_torch.core.devices import DeviceMesh
    from thinvids_tpu_torch.ingest.decode import open_video
    from thinvids_tpu_torch.io.mp4 import mux_mp4

    meshes, tag = _farm_meshes()
    print(tag, flush=True)
    entries = [d for m in meshes.values() for d in m.devices]
    kernels = check_farm_slice_kernels(entries, groups=((0, 2), (2, 4)))
    frames = make_frames(n, w, h)
    if stream is None:
        stream = concat_segments(_sfe_encoder(
            VideoMeta(width=w, height=h, fps_num=30, fps_den=1,
                      num_frames=n), qp, gop, bands, halo,
            device=entries[0]).encode(frames))
    digest = hashlib.sha256(stream).hexdigest()
    check((len(stream), digest) == SFE_POINT_JAX["bench_2160p"],
          f"mesh farm point: the 4-band stream ({len(stream)}, {digest}) "
          f"is not the JAX package's {SFE_POINT_JAX['bench_2160p']}")
    with tempfile.TemporaryDirectory(prefix="tvt-meshfarm-") as tmp, \
            _remote_daemon(tmp, card, device, gop, qp) as (base, coord,
                                                           dirs, _):
        path = os.path.join(dirs["inputs"], "farm2160.y4m")
        _write_clip(path, frames, w, h)
        del frames
        with open_video(path) as src:
            meta = src.meta
        with _worker_threads(base, coord, meshes, device):
            run = _farm_sfe_job(base, coord, path, bands, halo, device)
    p_frames = n - -(-n // gop)
    want = _per_card(DeviceMesh(entries), [p_frames] * len(entries))
    fig = {"fps": round(n / run["run_s"], 3), "latency": run["latency"],
           "stage_ms": {k: run["stage_ms"][k] for k in
                        ("halo", "dispatch", "device_wait", "fetch",
                         "sfe")}}
    print(f"mesh farm point {w}x{h} x{n} gop {gop} qp {qp}, {bands} bands "
          f"as 2 slices of 2, one band a run, halo {halo}: MP4 "
          f"{len(run['mp4'])} bytes, sha256 "
          f"{hashlib.sha256(run['mp4']).hexdigest()}; submit to done "
          f"{run['job']['finished_at'] - run['job']['created_at']:.3f} s, "
          f"run {run['run_s']:.3f} s; ME launches by card index "
          f"{run['by_card']}; {json.dumps(fig)}; phase 16's 2-band farm "
          f"(one card a worker): fps {farm.get('fps')}, stage_ms "
          f"{json.dumps(farm.get('stage_ms'))}, latency "
          f"{json.dumps(farm.get('latency'))}; {tag}; card {card}",
          flush=True)
    check(run["mp4"] == mux_mp4(stream, meta),
          "the mesh farm's MP4 differs from the mux of the 4-band stream")
    _check_by_device("mesh farm point", run["by_card"], want)
    check(run["stage_ms"]["dense_fallback_waves"] == 0,
          "the mesh farm run replayed dense")
    return {"launches_by_device": run["by_card"],
            "per_entry": [p_frames] * len(entries), "fig": fig,
            "kernels": kernels, "meshes": tag}


def mesh_phase(main: dict, sfe: dict, farm: dict | None = None,
               card: str | None = None) -> dict:
    mesh, tag = _mesh()
    run = mesh_run_kernels(mesh, tag)
    gop = mesh_gop_point(mesh, tag, main)
    band = mesh_sfe_point(mesh, tag, sfe)
    slices = mesh_farm_point(card or card_line(), farm or {},
                             band.pop("stream"))
    return {"mesh": tag, "run": run, "gop": gop, "sfe": band,
            "farm": slices}


# ---- phase 18 ------------------------------------------------------------

def check_cli() -> dict:
    """`cli check --json` in its own process, with `-X importtime` so
    the modules it imported are listed: exit 0, no open finding, no
    stale waiver, and neither torch nor jax among its imports."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "thinvids_tpu_torch.cli",
         "check", "--json"], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    check(res.returncode == 0, f"cli check exited {res.returncode}: "
          f"{res.stdout[-2000:]} {res.stderr[-2000:]}")
    doc = json.loads(res.stdout)
    imported = {line.rsplit("|", 1)[-1].strip()
                for line in res.stderr.splitlines()
                if line.startswith("import time:")}
    device = sorted(m for m in imported
                    if m.split(".")[0] in ("torch", "jax", "triton"))
    check(not device, f"cli check imported {device}")
    check(doc["open"] == [] and doc["stale_waivers"] == [],
          f"cli check: open {doc['open']}, stale {doc['stale_waivers']}")
    waived = [w["key"] for w in doc["waived"]]
    print(f"cli check: {doc['modules_scanned']} modules, 0 open, "
          f"waived {json.dumps(waived)}, {len(imported)} modules imported "
          f"(no torch, no jax), {secs:.2f} s", flush=True)
    return {"modules": doc["modules_scanned"], "waived": waived}


class SyncAudit:
    """Counts the host syncs torch.cuda.set_sync_debug_mode("warn")
    reports while it is active, per site: the innermost frame in
    thinvids_tpu_torch of the stack that issued the warning (taken in a
    warnings.showwarning hook: `record=True` would lose the stack). The
    hook sees the warnings of every thread (collectors, pack pool)."""

    ROOT = os.path.dirname(os.path.abspath(__file__))
    PKG = os.path.join(ROOT, "thinvids_tpu_torch") + os.sep

    def __init__(self) -> None:
        self.sites: dict = {}
        self.unattributed = 0

    def _site(self) -> tuple | None:
        import traceback

        for fr in reversed(traceback.extract_stack()):
            if fr.filename.startswith(self.PKG):
                rel = os.path.relpath(fr.filename[:-3], self.ROOT)
                mod = rel.replace(os.sep, ".").removesuffix(".__init__")
                return mod, fr.name, fr.lineno
        return None

    def __enter__(self):
        import warnings

        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("always")
        orig = warnings.showwarning

        def hook(message, category, filename, lineno, file=None,
                 line=None):
            if "synchronizing CUDA operation" not in str(message):
                return orig(message, category, filename, lineno, file, line)
            site = self._site()
            if site is None:
                self.unattributed += 1
            else:
                self.sites[site] = self.sites.get(site, 0) + 1

        warnings.showwarning = hook
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.set_sync_debug_mode("default")
        self._ctx.__exit__(*exc)

    def total(self) -> int:
        return sum(self.sites.values()) + self.unattributed

    def by_function(self) -> dict:
        out: dict = {}
        for (mod, fn, line), n in sorted(self.sites.items()):
            key = f"{mod}:{fn}"
            out[key] = out.get(key, 0) + n
        return out


def _judge_sites(audits: dict) -> None:
    """Every runtime sync site against the manifest: inside the
    sync_allowlist or named by an S001/S002 waiver, and never in a
    declared hot loop."""
    from thinvids_tpu_torch.analysis.astutil import matches_any
    from thinvids_tpu_torch.analysis.manifest import default_manifest

    m = default_manifest()
    waived_mods = {k.split(":")[1] for k in m.waivers
                   if k.startswith(("TVT-S001:", "TVT-S002:"))}
    hot = {tuple(h.split(":")) for h in m.hot_loops}
    bad = []
    for name, audit in audits.items():
        check(audit.unattributed == 0,
              f"{name}: {audit.unattributed} syncs outside the package")
        for mod, fn, line in audit.sites:
            where = f"{name}: {mod}:{fn} (line {line})"
            if any(hm == mod and hq.split(".")[-1] == fn
                   for hm, hq in hot):
                bad.append(f"{where} is a declared hot loop")
            elif not (matches_any(mod, m.sync_allowlist)
                      or mod in waived_mods):
                bad.append(f"{where} is outside the sync allowlist")
    check(not bad, "runtime sync sites: " + "; ".join(bad))


def explicit_sync_seen() -> dict:
    """How many syncs the debug mode reports for each explicit wait."""
    ev = torch.cuda.Event()
    out = {}
    for name, fn in (("torch.cuda.synchronize", torch.cuda.synchronize),
                     ("Event.synchronize",
                      lambda: (ev.record(), ev.synchronize())),
                     ("Stream.synchronize",
                      lambda: torch.cuda.current_stream().synchronize())):
        with SyncAudit() as a:
            fn()
        out[name] = a.total()
    return out


def sync_audit(main: dict, w: int = 1920, h: int = 1080, n: int = 16,
               qp: int = 27, gop: int = 8) -> dict:
    """Phase 18 (b) and (c): the runtime sync sites of the main path and
    of one IDR frame, then the pack_workers resize."""
    from thinvids_tpu_torch.codecs.h264 import torchcore, torchinter

    frames = make_frames(n, w, h)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    enc = GopShardEncoder(meta, qp=qp, gop_frames=gop, device="cuda")
    concat_segments(enc.encode(frames))          # warm-up, unaudited
    _zero_me_counts()
    with SyncAudit() as main_audit:
        stream = concat_segments(enc.encode(frames))
    launches = _me_counts()
    p_frames = n - len(enc.plan(n).gops)
    check(stream == main["stream"], "the audited main path changed bytes")
    for name, count in launches.items():
        check(count == p_frames, f"audited main path: {name} launched "
              f"{count} times, want {p_frames}")

    meta1 = VideoMeta(width=w, height=h, fps_num=30, fps_den=1,
                      num_frames=1)
    ienc = GopShardEncoder(meta1, qp=qp, gop_frames=1, inter=False,
                           device="cuda")
    concat_segments(ienc.encode(frames[:1]))      # warm-up
    with SyncAudit() as idr_audit:
        concat_segments(ienc.encode(frames[:1]))

    # one IDR frame's and one P frame's device step alone
    dev = torch.device("cuda", 0)
    pf = [f.padded(16) for f in frames[:2]]
    ys, us, vs = (torch.from_numpy(np.stack([getattr(f, p) for f in pf]))
                  .to(dev) for p in "yuv")
    mbh, mbw = ys.shape[1] // 16, ys.shape[2] // 16
    qpc = torchcore.chroma_qp(qp)
    pmv = torch.zeros(2, dtype=torch.int32, device=dev)
    with SyncAudit() as idr_step:
        _, (ry, ru, rv) = torchinter._intra_frame_outputs(
            ys[0], us[0], vs[0], qp, mbw=mbw, mbh=mbh)
    with SyncAudit() as p_step:
        torchinter._encode_p_plane(ys[1], us[1], vs[1], ry, ru, rv, pmv,
                                   qp, qpc, mbw=mbw, mbh=mbh)
    torch.cuda.synchronize()

    audits = {"main": main_audit, "idr_frame": idr_audit,
              "idr_step": idr_step, "p_step": p_step}
    for name, a in audits.items():
        print(f"syncs {name}: {a.total()} "
              f"{json.dumps(a.by_function())}", flush=True)
    print(f"syncs per frame: main path {main_audit.total() / n:.2f} "
          f"({n} frames), all-intra IDR frame {idr_audit.total()}, IDR "
          f"device step {idr_step.total()}, P device step "
          f"{p_step.total()}; ME launches {launches}", flush=True)
    seen = explicit_sync_seen()
    print(f"sync debug mode reports the explicit waits: "
          f"{json.dumps(seen)}", flush=True)
    _judge_sites(audits)

    # (c) the pack pool resized per call
    _, waves = enc.prepare_waves(frames)
    for pw in (1, 8):
        s2 = concat_segments(enc.encode_waves(waves, pack_workers=pw))
        check(enc.pack_workers == pw and s2 == main["stream"],
              f"encode_waves(pack_workers={pw}) changed the stream")
    print("encode_waves(pack_workers=1) and (pack_workers=8) give phase "
          "4's stream", flush=True)
    return {"syncs": {k: a.by_function() for k, a in audits.items()},
            "explicit": seen, "launches": launches}


def check_phase(main: dict, card: str) -> dict:
    t0 = time.perf_counter()
    out = {"cli": check_cli(), "audit": sync_audit(main)}
    print(f"check phase {time.perf_counter() - t0:.1f} s; {card}",
          flush=True)
    return out


# ---- phase 19 ------------------------------------------------------------

#: the intra RD configs phase 19 holds the card against the numpy spec in
SPEC_RD = {"off": RD_OFF, "md": RdConfig(mode_decision=True),
           "aq": RdConfig(aq_q=aq_from_strength(1.0)),
           "md_aq": RdConfig(mode_decision=True, aq_q=aq_from_strength(1.0))}


def _spec_frame(dev, y, u, v, qp: int, rd, tag: str) -> dict:
    """One padded frame through the card's intra program
    (torchcore.encode_intra's levels, _intra_core's recon) and through
    the numpy specification (encoder.encode_frame_arrays): levels and
    recon must be equal. Returns each side's seconds (the card's warm:
    upload, compute and fetch, after one untimed call)."""
    from thinvids_tpu_torch.codecs.h264 import torchcore
    from thinvids_tpu_torch.codecs.h264.encoder import encode_frame_arrays

    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    torchcore.encode_intra(y, u, v, qp, rd, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = torchcore.encode_intra(y, u, v, qp, rd, device=dev)
    card_s = time.perf_counter() - t0
    yd, ud, vd = (torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                  for p in (y, u, v))
    recon = [r.cpu().numpy() for r in torchcore._intra_core(
        yd, ud, vd, qp, mbw=mbw, mbh=mbh, rd=rd)[4:7]]
    t0 = time.perf_counter()
    want, want_recon = encode_frame_arrays(y, u, v, qp, rd=rd)
    spec_s = time.perf_counter() - t0
    for name in ("luma_mode", "chroma_mode", "luma_dc", "luma_ac",
                 "chroma_dc", "chroma_ac", "qp_delta"):
        a, b = getattr(got, name), getattr(want, name)
        check((a is None) == (b is None)
              and (a is None or np.array_equal(a, b)),
              f"spec {tag}: the card's {name} differs from "
              "encode_frame_arrays'")
    for plane, a, b in zip("yuv", recon, want_recon):
        check(np.array_equal(a, b), f"spec {tag}: the card's recon {plane} "
                                    "differs from encode_frame_arrays'")
    return {"card_s": card_s, "spec_s": spec_s}


def spec_phase(dev, card: str) -> None:
    """The card's intra program against the reference's numpy
    specification: bench content at 352x288 for RD off, mode decision,
    AQ and both; one 1080p RD-off IDR frame; then an 8-entry mesh
    aliased on one card, whose all-intra sharded stream must equal the
    per-frame numpy encode in the 8-wide GOP plan. No ME kernel runs."""
    from thinvids_tpu_torch.codecs.h264.encoder import H264Encoder
    from thinvids_tpu_torch.core.devices import DeviceMesh
    from thinvids_tpu_torch.parallel.dispatch import encode_clip_sharded
    from thinvids_tpu_torch.parallel.planner import plan_segments

    t_phase = time.perf_counter()
    _zero_me_counts()
    f = make_frames(1, 352, 288, seed=3)[0].padded(16)
    secs = {}
    for tag, rd in SPEC_RD.items():
        secs[f"352x288_{tag}"] = _spec_frame(dev, f.y, f.u, f.v, 27, rd,
                                             f"352x288 {tag}")
    f = make_frames(1, 1920, 1080, seed=1)[0].padded(16)
    secs["1080p_off"] = _spec_frame(dev, f.y, f.u, f.v, 27, RD_OFF,
                                    "1080p off")
    print(f"spec intra == encode_frame_arrays (levels and recon, qp 27), "
          f"seconds per frame {json.dumps(secs)}; {card}", flush=True)

    w, h, n, gop, qp = 64, 48, 16, 2, 27
    rng = np.random.default_rng(0)
    frames = [Frame(y=rng.integers(0, 256, (h, w), dtype=np.uint8),
                    u=rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
                    v=rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
              for _ in range(n)]
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    mesh = DeviceMesh([dev] * 8)
    got = encode_clip_sharded(frames, meta, qp=qp, gop_frames=gop,
                              inter=False, device=dev, mesh=mesh)
    spec = H264Encoder(meta, qp=qp, use_device=False)
    want = b"".join(
        spec.encode_frame(frames[i], idr_pic_id=i,
                          with_headers=(i == g.start_frame))
        for g in plan_segments(n, gop, mesh.size).gops
        for i in range(g.start_frame, g.end_frame))
    check(got == want, f"8-entry aliased mesh all-intra stream "
                       f"({len(got)} bytes) differs from the numpy spec's "
                       f"({len(want)} bytes)")
    check(all(v == 0 for v in _me_counts().values()),
          f"phase 19 launched ME kernels: {_me_counts()}")
    print(f"spec mesh {mesh}: all-intra {w}x{h} x{n} gop {gop} qp {qp} "
          f"stream == the numpy spec's in the 8-wide plan ({len(got)} bytes,"
          f" sha256 {hashlib.sha256(got).hexdigest()}); spec phase "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)


# ---- phase 15 ------------------------------------------------------------

def parity_phase() -> None:
    """The 352x288 card == CPU checks of phases 9, 10 and 12, after every
    timed section: the CPU port's side of phases 9 and 10 runs in two
    worker processes while the card runs its side, so no timed figure
    shares the host with them."""
    import concurrent.futures as cf
    import multiprocessing as mp

    secs = {}
    workers = cf.ProcessPoolExecutor(2, mp_context=mp.get_context("spawn"))
    try:
        cpu = {k: workers.submit(_cpu_side, k) for k in ("rd", "sfe")}
        # the ladder's check first: its CPU side runs in this process
        for name, fn in (("ladder_card_equals_cpu", ladder_card_equals_cpu),
                         ("rd_card_equals_cpu",
                          lambda: rd_card_equals_cpu(cpu["rd"].result)),
                         ("sfe_card_equals_cpu",
                          lambda: sfe_card_equals_cpu(cpu["sfe"].result))):
            t0 = time.perf_counter()
            fn()
            secs[name] = round(time.perf_counter() - t0, 1)
    finally:
        _shutdown_pool(workers)
    print(f"card == CPU seconds {json.dumps(secs)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t_run = time.perf_counter()

    def phase(name: str) -> None:
        print(f"-- phase {name} at {time.perf_counter() - t_run:.1f} s",
              flush=True)

    phase("2 build")
    build_all()
    phase("3 kernels")
    print("kernels: me_halfpel, me_search")
    recs = check_me_kernels(dev)
    banded = check_banded_me_kernels(dev)
    farm_slice = check_farm_slice_kernels([dev, dev])
    phase("4 main")
    main = main_path()
    for rec in recs:
        rec["launches"] = main["launches"][rec["name"]]
    time_breakdown(dev)
    phase("5 parity")
    card_equals_cpu()
    import tempfile

    phase("6-7 job")
    with tempfile.TemporaryDirectory(prefix="tvt-smoke-") as tmp:
        job_mp4 = job_path(tmp, main["stream"])
        job_parity(tmp)
    phase("8 intra")
    intra_wave()
    phase("9 rd")
    rd_phase(dev)
    phase("10 sfe")
    sfe = sfe_phase(dev)
    phase("11 rc")
    rc = rc_point()
    phase("12 ladder")
    ladder = ladder_phase(main)
    phase("13 live")
    live = live_phase()
    phase("14 manager")
    manager = manager_phase(job_mp4, ladder["job_tree"], card)
    phase("16 farm")
    farm = farm_phase(job_mp4, card)
    phase("17 mesh")
    mesh = mesh_phase(main, sfe, farm, card)
    phase("15 card = CPU")
    parity_phase()
    phase("18 check")
    checked = check_phase(main, card)
    phase("19 spec")
    spec_phase(dev, card)
    for rec in recs:
        rec["banded"] = dict(banded[rec["name"]],
                             launches=sfe["launches"][rec["name"]])
        rec["rc_launches_per_pass"] = rc["launches_per_pass"][rec["name"]]
        rec["ladder_launches"] = ladder["launches"][rec["name"]]
        rec["live_launches"] = live["ladder"][rec["name"]]
        rec["live_sfe_launches"] = live["sfe"][rec["name"]]
        rec["manager_launches"] = manager[rec["name"]]
        rec["farm_slice"] = farm_slice[rec["name"]]
        rec["farm_launches"] = farm["launches"][rec["name"]]
        rec["mesh"] = {
            "mesh": mesh["mesh"],
            "gop_launches_by_card": mesh["gop"]["launches_by_device"][
                rec["name"]],
            "gop_launches_per_entry": mesh["gop"]["per_entry"],
            "sfe_launches_by_card": mesh["sfe"]["launches_by_device"][
                rec["name"]],
            "sfe_launches_per_entry": mesh["sfe"]["per_entry"],
            "run_stack": mesh["run"][rec["name"]],
            "farm_launches_by_card": mesh["farm"]["launches_by_device"][
                rec["name"]],
            "farm_launches_per_entry": mesh["farm"]["per_entry"],
            "farm_run_stack": mesh["farm"]["kernels"][rec["name"]]}
        rec["sync_audit_launches"] = checked["audit"]["launches"][
            rec["name"]]
    phase("end")
    print(json.dumps({"kernels": recs}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
