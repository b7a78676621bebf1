"""Chip smoke run of the PyTorch/CUDA port (thinvids_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. device   — require CUDA; print the card (nvidia-smi name, power
              limit), torch/CUDA versions and the device count.
2. build    — build the ME kernel (nvcc, csrc/me_search.cu) and the host
              CAVLC packer (g++, native/cavlc_pack.cpp) concurrently, from
              the sources in this checkout; print each build's seconds.
3. kernels  — hold every hand-written kernel against its plain PyTorch
              version on the card, bit-exactly, at the main path's shapes
              and on small ones; time both at 1088x1920 (CUDA events,
              median of 25, plain version median of 20) beside the kernel's bound.
4. main     — the 1080p closed-GOP encode (16 frames, gop 8, qp 27)
              through GopShardEncoder(device="cuda").encode →
              concat_segments, with every kernel's launch count set to 0
              just before and read just after; check the stream's SPS and
              slice count; then the bench-style e2e and device-only fps,
              and the time of one GOP's parts (IDR frame, P frame and its
              centres / kernel / median / residual, transfer pack).
5. parity   — the same content at 352x288 (24 frames, gop 8) encoded on
              the card and on the CPU must give identical bytes.

Before the last line it prints one JSON object of kernel records and the
card's name and power limit; the last line is the device JSON object.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from thinvids_tpu_torch import native
from thinvids_tpu_torch.codecs.h264 import headers, torchme
from thinvids_tpu_torch.core.types import Frame, VideoMeta, concat_segments
from thinvids_tpu_torch.io.bits import split_annexb
from thinvids_tpu_torch.parallel.dispatch import GopShardEncoder

#: int32 operation rate of one H100 SXM: 132 SMs x 64 INT32 lanes x
#: 1.98 GHz boost (NVIDIA Hopper architecture white paper), at the
#: card's full 700 W power limit
H100_INT32_OPS = 132 * 64 * 1.98e9
#: HBM3 bandwidth of one H100 SXM (NVIDIA data sheet)
H100_BYTES_PER_S = 3.35e12


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
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")


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


def _median_ms(fn, reps: int = 25) -> float:
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


def check_me_kernel(dev) -> dict:
    """me_search_cuda vs me_search_ref on the card, bit-exact."""
    cases = []
    for (h, w) in [(48, 64), (128, 192), (1088, 1920)]:
        for i, kind in enumerate(("mixed", "pan", "noise", "range")):
            cases.append((kind, h, w, i, None))
    # coinciding centres: probe = median = zero
    cases.append(("noise", 128, 192, 7, "zero"))
    cases.append(("mixed", 1088, 1920, 8, "zero"))
    max_err = 0
    for kind, h, w, seed, cent in cases:
        cur, ref, ru, rv = (torch.from_numpy(a.astype(np.int16)).to(dev)
                            for a in _me_inputs(kind, h, w, seed))
        pmv = torch.tensor([5, -9], dtype=torch.int32, device=dev)
        if cent == "zero":
            centers = torch.zeros((3, 2), dtype=torch.int32, device=dev)
        else:
            centers = torchme.centers_from(cur, ref, pmv)
        lam = torchme.lambda_for(27, dev)
        got = torchme.me_search_cuda(cur, ref, ru, rv, centers, lam)
        torch.cuda.synchronize()
        want = torchme.me_search_ref(cur, ref, ru, rv, centers, lam)
        for name, a, b in zip(("mv", "pred_y", "pred_u", "pred_v"),
                              got, want):
            err = int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"me_search {kind} {h}x{w} {cent}: {name} "
                            f"differs (max |diff| {err})")
        nmv = len({tuple(v) for v in got[0].reshape(-1, 2).tolist()})
        print(f"me_search {kind:5s} {h}x{w} centres="
              f"{centers.tolist()}: bit-exact ({nmv} distinct MVs)",
              flush=True)

    # timing at the main path's shape
    h, w = 1088, 1920
    cur, ref, ru, rv = (torch.from_numpy(a.astype(np.int16)).to(dev)
                        for a in _me_inputs("pan", h, w, 3))
    centers = torchme.centers_from(
        cur, ref, torch.zeros(2, dtype=torch.int32, device=dev))
    lam = torchme.lambda_for(27, dev)
    ms = _median_ms(lambda: torchme.me_search_cuda(cur, ref, ru, rv,
                                                   centers, lam))
    plain_ms = _median_ms(lambda: torchme.me_search_ref(cur, ref, ru, rv,
                                                        centers, lam),
                          reps=20)
    ms2 = _median_ms(lambda: torchme.me_search_cuda(cur, ref, ru, rv,
                                                    centers, lam))
    ops = len(torchme.OFFSET_TABLE) * h * w * 3       # sub, abs, add
    nbytes = (2 * h * w * 2 + 2 * (h // 2) * (w // 2) * 2 + 3 * 2 * 4 + 4
              + (h // 16) * (w // 16) * 2 * 4 + h * w * 2
              + 2 * (h // 2) * (w // 2) * 2)
    t_ops = ops / H100_INT32_OPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    print(f"me_search 1088x1920: kernel {ms:.4f} ms (again {ms2:.4f} ms), "
          f"plain {plain_ms:.2f} ms, bound {max(t_ops, t_bytes):.4f} ms "
          f"({ops / 1e9:.3f} G int32 ops -> {t_ops:.4f} ms; "
          f"{nbytes / 1e6:.2f} MB -> {t_bytes:.4f} ms)", flush=True)
    return {"name": "me_search", "route": "cuda",
            "source": "thinvids_tpu_torch/csrc/me_search.cu",
            "replaces": "thinvids_tpu/codecs/h264/jaxme.py:265",
            "launches": None, "max_abs_err": max_err,
            "ms": min(ms, ms2), "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


# ---- phase 4 -----------------------------------------------------------

def main_path(w: int = 1920, h: int = 1080, n: int = 16, qp: int = 27,
              gop: int = 8) -> dict:
    frames = make_frames(n, w, h)
    meta = VideoMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    enc = GopShardEncoder(meta, qp=qp, gop_frames=gop, device="cuda")
    concat_segments(enc.encode(frames))          # warm-up pass
    torch.cuda.synchronize()

    torchme.ME_KERNEL_LAUNCHES = 0
    enc.stages.reset()
    t0 = time.perf_counter()
    stream = concat_segments(enc.encode(frames))
    t_cold = time.perf_counter() - t0
    launches = torchme.ME_KERNEL_LAUNCHES
    snap = enc.stages.snapshot()
    p_frames = n - len(enc.plan(n).gops)
    print(f"main path {w}x{h} x{n} gop {gop} qp {qp}: {len(stream)} "
          f"bytes, {n / t_cold:.3f} fps through encode() "
          f"(staging included), ME launches {launches}, "
          f"dense_fallback_waves {snap['dense_fallback_waves']}",
          flush=True)
    check(snap["dense_fallback_waves"] == 0,
          "the 1080p bench content fell back to the dense transfer")
    check(launches == p_frames,
          f"ME kernel launched {launches} times, want {p_frames} "
          "(one per P frame)")
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
    return {"launches": launches}


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
    print("kernels: me_search")
    rec = check_me_kernel(dev)
    rec["launches"] = main_path()["launches"]
    time_breakdown(dev)
    card_equals_cpu()
    print(json.dumps({"kernels": [rec]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
