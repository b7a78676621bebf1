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
              qp 0 / 27 / 51); time each at 1088x1920 with CUDA events
              around 50 back-to-back launches (eagerly and as one CUDA
              graph), median of 5, plain versions median of 5, beside
              each kernel's bound.
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
              encode_gop streams; at 352x288 the card's bytes and recon
              equal the CPU's for every RD config the CPU tests use, the
              all-intra wave with mode decision + AQ, and the process pack
              with every feature on; and the breakdown of the RD parts
              (IDR frame per feature, P frame with the P_Skip bias and
              the filter, the filter alone by CUDA events).

Before the last line it prints one JSON object of kernel records and the
card's name and power limit; the last line is the device JSON object.
"""

from __future__ import annotations

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


def me_bounds(h: int, w: int) -> dict:
    """(operations, bytes) each ME kernel must do and move at h x w.
    Operations are counted in the instruction the kernel uses: one
    VABSDIFF4 takes four pixel differences and their sum, so the search
    needs 227 h w / 4; the prepass one multiply-add per tap of its three
    6-tap filters (b, h, and j over b's unrounded sums) per plane sample.
    Bytes: each input read once, each output written once."""
    hp, wp = h + 2 * torchme.ME_HALO, w + 2 * torchme.ME_HALO
    planes = 4 * hp * wp
    chroma = 2 * (h // 2) * (w // 2) * 2
    # cur, chroma refs, centres, lam in; mv, pred_y, pred_u, pred_v out
    rest = (h * w * 2 + chroma + 3 * 2 * 4 + 4
            + (h // 16) * (w // 16) * 2 * 4 + h * w * 2 + chroma)
    pre_ops = 3 * 6 * hp * wp
    search_ops = len(torchme.OFFSET_TABLE) * h * w // 4
    return {
        "me_halfpel": (pre_ops, h * w * 2 + planes),
        "me_search": (search_ops, planes + rest),
        # both kernels as one function: the planes stay inside it
        "me_total": (pre_ops + search_ops, h * w * 2 + rest),
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
    # 80 and 176 columns are 5 and 11 MBs: strips of 4 MBs run past them
    for (h, w) in [(48, 64), (48, 80), (128, 192), (144, 176), (1088, 1920)]:
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
    return {"launches": launches, "stream": stream}


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
             n: int = 16) -> None:
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


def _shutdown_sidecars(enc) -> None:
    pool = enc._proc_pool
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


def rd_card_equals_cpu(w: int = 352, h: int = 288, n: int = 8) -> None:
    from thinvids_tpu_torch.codecs.h264.encoder import encode_gop

    frames = make_frames(n, w, h, seed=7, pan=2)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    sizes = {}
    for name, rd in RD_TEST_CONFIGS.items():
        got = {dev: encode_gop(frames, meta, qp=27, return_recon=True, rd=rd,
                               device=dev) for dev in ("cuda", "cpu")}
        check(got["cuda"][0] == got["cpu"][0],
              f"RD {name}: card and CPU streams differ")
        for a, b, plane in zip(got["cuda"][1], got["cpu"][1], "yuv"):
            check(np.array_equal(a, b),
                  f"RD {name}: card and CPU recon {plane} differ")
        sizes[name] = len(got["cuda"][0])
    md_aq = RdConfig(mode_decision=True, aq_q=4)
    intra = {}
    for dev in ("cuda", "cpu"):
        enc = GopShardEncoder(meta, qp=27, gop_frames=4, inter=False,
                              rd=md_aq, device=dev)
        intra[dev] = concat_segments(enc.encode(frames))
    check(intra["cuda"] == intra["cpu"],
          "all-intra wave with mode decision + AQ: card and CPU differ")
    base = concat_segments(GopShardEncoder(
        meta, qp=27, gop_frames=4, rd=RD_ALL, device="cpu").encode(frames))
    enc = GopShardEncoder(meta, qp=27, gop_frames=4, rd=RD_ALL,
                          pack_backend="process", device="cuda")
    try:
        check(enc._proc_pool is not None, "no pack sidecar pool started")
        got = concat_segments(enc.encode(frames))
        gops = enc.stages.snapshot()["proc_pack_gops"]
    finally:
        _shutdown_sidecars(enc)
    check(got == base, "RD_ALL process pack on the card differs from the "
                       "CPU's thread pack")
    check(gops == 2, f"the sidecars packed {gops} RD_ALL GOPs, want 2")
    print(f"rd parity {w}x{h} x{n}: card == CPU (bytes and recon) for "
          f"{json.dumps(sizes)}; all-intra md+aq4 card == CPU "
          f"({len(intra['cuda'])} bytes); RD_ALL process pack on the card "
          f"== CPU ({len(got)} bytes, {gops} GOPs on the sidecars)",
          flush=True)


def rd_breakdown(dev, w: int = 1920, h: int = 1080, qp: int = 25) -> dict:
    """Where the RD features' time goes at 1080p: the IDR frame per
    feature set, one P frame with the P_Skip bias and the filter, and the
    filter alone (host clock around a synchronize, best of 3; the filter
    also by CUDA events, median of 5)."""
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
    # in turns: every part once per round, best of 3 rounds, so a drift
    # of the shared host's speed during the phase spreads over all parts
    ms = {k: float("inf") for k in parts}
    for _ in range(3):
        for k, fn in parts.items():
            ms[k] = min(ms[k], _sync_ms(fn, reps=1))
    ms = {k: round(v, 3) for k, v in ms.items()}
    events = {"deblock_intra": round(_median_ms(deb_i), 3),
              "deblock_p": round(_median_ms(deb_p), 3)}
    print(f"rd breakdown_ms {w}x{h} qp {qp} (host clock, synced, best of 3 "
          f"rounds in turns): {json.dumps(ms)}", flush=True)
    print(f"rd deblock_frame_torch {w}x{h} by CUDA events (median of 5, one "
          f"call each): {json.dumps(events)}", flush=True)
    busy = {k: _device_busy(parts[k]) for k in
            ("idr_rd_off", "idr_rd_all", "p_rd_off", "p_pskip_deblock")}
    print(f"rd device busy {w}x{h} (torch.profiler, one call each: kernels "
          f"launched, their summed device ms, the call's wall ms under the "
          f"profiler): {json.dumps(busy)}", flush=True)
    return {"host_ms": ms, "event_ms": events, "busy": busy}


def _device_busy(fn) -> dict | str:
    """Kernels one call launches and the device time they take, from a
    torch.profiler trace of the call; the rest of its wall time the card
    idles while the host enqueues."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        fn()
        torch.cuda.synchronize()
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
    point = rd_point()
    rd_shard_encoder(point)
    rd_card_equals_cpu()
    rd_breakdown(dev)
    on, off = point["point"]["on"], point["point"]["off"]
    print(f"rd point summary: on {on['bits_per_frame']} bits/frame at "
          f"{on['psnr_y']} dB, off {off['bits_per_frame']} at "
          f"{off['psnr_y']} dB; both streams equal the JAX package's",
          flush=True)


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
    build_all()
    print("kernels: me_halfpel, me_search")
    recs = check_me_kernels(dev)
    main = main_path()
    for rec in recs:
        rec["launches"] = main["launches"][rec["name"]]
    time_breakdown(dev)
    card_equals_cpu()
    import tempfile

    with tempfile.TemporaryDirectory(prefix="tvt-smoke-") as tmp:
        job_path(tmp, main["stream"])
        job_parity(tmp)
    intra_wave()
    rd_phase(dev)
    print(json.dumps({"kernels": recs}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
