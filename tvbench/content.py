"""Seeded video content: a camera pan over a detailed scene.

A frozen copy of `make_frames` (chip_smoke.py:461 at commit ae0a2c4: a
gradient, a texture and static grain under a diagonal pan, the
repository's bench content), extended so that no frame repeats within a
clip or a stream: the scene is drawn from the seed (grain, texture phases)
and the pan wraps around it, with periods of 1024 rows and 1022 columns,
so frame i and frame j show the same picture only when 3 (j - i) is a
multiple of both (523,264 frames apart). Every seed gives the same
sizes and the same pan; only the picture differs.
"""

from __future__ import annotations

import numpy as np

#: scene period in luma rows and columns (even, for 4:2:0; the pan's
#: offsets repeat after lcm(1024, 1022) = 523,264 frames)
PERIOD = (1024, 1022)
#: luma pixels the camera moves a frame, down and right (bench's pan)
PAN = 3


class Scene:
    """The frames of one seeded pan at width x height, each made on
    demand as a view into a tiled scene (no copy)."""

    def __init__(self, seed: int, width: int, height: int,
                 pan: int = PAN) -> None:
        if width % 2 or height % 2:
            raise ValueError("4:2:0 needs even width and height")
        self.seed, self.width, self.height, self.pan = seed, width, height, pan
        rng = np.random.default_rng(seed)
        ph, pw = PERIOD
        ky, kx = rng.uniform(0, 2 * np.pi, 2)
        yy, xx = np.mgrid[0:ph, 0:pw]
        # the bench's luma recipe on one period: gradient, texture, grain
        base = ((xx * 0.1 + yy * 0.05) % 256
                + 24.0 * np.sin(xx * 0.07 + kx) * np.cos(yy * 0.05 + ky)
                + rng.normal(0, 6.0, (ph, pw)))
        y = np.clip(base, 0, 255).astype(np.uint8)
        cy, cx = np.mgrid[0:ph // 2, 0:pw // 2]
        u = np.clip(128 + 30 * np.sin(cx * 0.02 + kx), 0, 255).astype(np.uint8)
        v = np.clip(128 + 30 * np.cos(cy * 0.02 + ky), 0, 255).astype(np.uint8)
        # tile so that any window of the frame size is a plain slice
        self._y = np.tile(y, (height // ph + 2, width // pw + 2))
        self._u = np.tile(u, (height // ph + 2, width // pw + 2))
        self._v = np.tile(v, (height // ph + 2, width // pw + 2))

    def offset(self, i: int) -> tuple[int, int]:
        """(row, column) of frame i's top-left corner in the scene; the
        chroma window starts at half of each, as in `make_frames`."""
        d = self.pan * i
        return d % PERIOD[0], d % PERIOD[1]

    def planes(self, i: int):
        """(y, u, v) uint8 views of frame i."""
        oy, ox = self.offset(i)
        w, h = self.width, self.height
        return (self._y[oy:oy + h, ox:ox + w],
                self._u[oy // 2:oy // 2 + h // 2, ox // 2:ox // 2 + w // 2],
                self._v[oy // 2:oy // 2 + h // 2, ox // 2:ox // 2 + w // 2])
