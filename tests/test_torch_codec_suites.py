"""The reference's codec suites run over the port: tests/test_h264.py
(transforms, CAVLC, headers, encoder ↔ decoder, the libavcodec oracle),
tests/test_inter.py (GOP encodes against the oracle), tests/test_deblock.py
(the filter's tables, numpy ↔ device parity, band splits),
tests/test_jaxcore.py (the device intra program and the native packer
against the numpy specification) and tests/test_rdo.py (the RD features'
parity and conformance).

Each reference module is read with every `thinvids_tpu` import naming
`thinvids_tpu_torch` (tests/test_torch_job_suites.py's
`reference_cases`) and its cases run on the port's modules. The port's
encoders take ``device="cuda"`` by default, so the names the cases call
are CPU stand-ins: `H264Encoder`, `encode_frames`, `encode_gop`,
`GopShardEncoder` and `torchcore.encode_intra` with ``device="cpu"``.
The reference's JAX names are read as the port's: ``use_jax=`` →
``use_device=``, ``jaxcore.encode_intra_jax`` → ``torchcore.encode_intra``
(the same signature apart from ``device``), ``jaxdeblock.deblock_frame_jax``
→ ``torchdeblock.deblock_frame_torch``.

Left out by name, each with the port test that takes its place:

- test_rdo.py ``TestIntraParity.test_satd_matches_direct_hadamard``
  calls ``jaxcore._satd16`` on a ``jnp`` array:
  `test_satd16_matches_direct_hadamard` below, same content and seed.
- test_deblock.py ``TestOracleParity.test_shifted_plane_bound_vs_libavcodec``
  fails on the reference (ROADMAP C, known reference-side failures); the
  port's deblock is byte-held to `deblock.deblock_frame`, and over the
  port the case fails the same way ("frame 0: max diff 9", against its
  bound of 4). The deblocked GOP streams' decode is held by
  ``TestStreamConformance`` (test_rdo.py) below.
- test_rdo.py ``TestShardedPaths.test_process_pack_backend_with_features``
  is marked slow in the reference and so is not in the tier-1 run; it is
  collected, and deselected by the same marker.

One harness pin: test_rdo.py's one-device JAX mesh
``Mesh(np.asarray(jax.devices()[:1]), ("gop",))`` is the one-entry
``DeviceMesh(("cpu",))``.
"""

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_job_suites import collect, on_the_cpu, reference_cases
from thinvids_tpu_torch.codecs.h264 import encoder as tencoder
from thinvids_tpu_torch.codecs.h264 import rdo as trdo
from thinvids_tpu_torch.codecs.h264 import torchcore
from thinvids_tpu_torch.core.devices import DeviceMesh
from thinvids_tpu_torch.parallel import dispatch as tdispatch

torch.set_num_threads(1)

#: module attribute → its CPU stand-in, in the port's modules and in the
#: namespace of every reference module executed here
CODEC_STANDINS = {
    (tencoder, "H264Encoder"): on_the_cpu(tencoder.H264Encoder),
    (tencoder, "encode_frames"):
        functools.partial(tencoder.encode_frames, device="cpu"),
    (tencoder, "encode_gop"):
        functools.partial(tencoder.encode_gop, device="cpu"),
    (torchcore, "encode_intra"):
        functools.partial(torchcore.encode_intra, device="cpu"),
    (tdispatch, "GopShardEncoder"): on_the_cpu(tdispatch.GopShardEncoder),
}

#: the reference's JAX names → the port's
CODEC_TERMS = (
    (r"\buse_jax=", "use_device="),
    (r"\bencode_intra_jax\b", "encode_intra"),
    (r"\bjaxcore\b", "torchcore"),
    (r"\bjaxdeblock import deblock_frame_jax\b",
     "torchdeblock import deblock_frame_torch as deblock_frame_jax"),
)


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    for (owner, attr), standin in CODEC_STANDINS.items():
        monkeypatch.setattr(owner, attr, standin)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _cases(name, pins=()):
    mod = reference_cases(name, CODEC_TERMS, CODEC_STANDINS, pins)
    mod.DeviceMesh = DeviceMesh
    return mod


collect(_cases("test_h264"), globals())
collect(_cases("test_inter"), globals())
collect(_cases("test_deblock"), globals(), leave_out={
    "TestOracleParity.test_shifted_plane_bound_vs_libavcodec"})
collect(_cases("test_jaxcore"), globals())
collect(_cases("test_rdo", pins=(
    ('Mesh(np.asarray(jax.devices()[:1]), ("gop",))',
     'DeviceMesh(("cpu",))'),)), globals(),
    leave_out={"TestIntraParity.test_satd_matches_direct_hadamard"})


def test_satd16_matches_direct_hadamard():
    """test_rdo's SATD case on the port: the device program's 16x16 SATD
    equals the numpy twin on the same seeded residual (tolerance 0)."""
    rng = np.random.default_rng(0)
    r = rng.integers(-200, 200, (16, 16)).astype(np.int32)
    got = int(torchcore._satd16(torch.from_numpy(r)[None])[0])
    assert got == trdo.satd16_np(r)
