"""Torch backend for the in-loop deblocking filter.

codecs/h264/deblock.py holds the single implementation of the §8.7
shifted-plane schedule, written against a small ops shim; this module
provides the torch shim so the SAME code runs inside the encode
programs on the plane's device (torchinter's IDR and P steps). One
semantics, two backends — the numpy/torch parity tests pin them
bit-identical, which is what keeps encoder recon equal to decoder output
under the filter.

The schedule indexes with small static numpy arrays (edge columns,
`xs - 4 … xs + 3`, the ALPHA/BETA/TC0/QP_C tables). Each is copied to
the device once and cached by (contents, device): without the cache
every gather of a pass would copy an index array to the card and stall
the host on it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .deblock import deblock_frame

#: numpy arrays up to this many elements are cached on the device
#: (static index sets and tables); larger ones are copied per call
_CACHE_MAX_ELEMS = 1 << 14


@functools.lru_cache(maxsize=1024)
def _device_array(raw: bytes, dtype: str, shape: tuple, device):
    a = np.frombuffer(raw, np.dtype(dtype)).reshape(shape)
    return torch.as_tensor(a.copy(), device=device)


class _TorchXp:
    """The element-wise functions the schedule calls as `xp.*`: torch's
    spellings, taking a Python int on either side as numpy does."""

    @staticmethod
    def where(cond, a, b):
        return torch.where(cond, a, b)

    @staticmethod
    def abs(a):
        return torch.abs(a)

    @staticmethod
    def minimum(a, b):
        if not isinstance(a, torch.Tensor):
            return torch.clamp(b, max=a)
        if not isinstance(b, torch.Tensor):
            return torch.clamp(a, max=b)
        return torch.minimum(a, b)

    @staticmethod
    def maximum(a, b):
        if not isinstance(a, torch.Tensor):
            return torch.clamp(b, min=a)
        if not isinstance(b, torch.Tensor):
            return torch.clamp(a, min=b)
        return torch.maximum(a, b)


class _TorchOps:
    """Backend shim: torch tensors on one device."""

    xp = _TorchXp()
    int32 = torch.int32

    def __init__(self, device: torch.device):
        self.device = device

    def asarray(self, a):
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        a = np.asarray(a)
        if a.size <= _CACHE_MAX_ELEMS:
            a = np.ascontiguousarray(a)
            return _device_array(a.tobytes(), a.dtype.str, a.shape,
                                 self.device)
        return torch.as_tensor(a, device=self.device)

    def _index(self, xs):
        """A static numpy column set as a cached int64 device tensor."""
        return self.asarray(np.asarray(xs, np.int64))

    def gather_cols(self, X, xs):
        return X[:, self._index(xs)]

    def scatter_cols(self, X, writes):
        """X with columns updated (one clone; the xs sets of one pass
        are mutually disjoint)."""
        out = X.clone()
        for xs, vals in writes:
            out[:, self._index(xs)] = vals.to(out.dtype)
        return out

    @staticmethod
    def astype(a, dtype):
        return a.to(dtype)

    @staticmethod
    def repeat(a, n: int, axis: int):
        return torch.repeat_interleave(a, n, dim=axis)

    @staticmethod
    def amax(a, axis: int):
        return torch.amax(a, dim=axis)

    @staticmethod
    def transpose(a, axes):
        return a.permute(*axes)

    @staticmethod
    def zeros_like(a):
        return torch.zeros_like(a)


@functools.lru_cache(maxsize=None)
def _ops_for(device: torch.device) -> _TorchOps:
    return _TorchOps(device)


def deblock_frame_torch(y, u, v, qp_map, *, intra: bool, nz4=None,
                        mv=None, mb_row0: int = 0,
                        total_mb_rows: int | None = None):
    """Deblock one (padded) frame or band slice on the planes' device —
    see deblock.deblock_frame for the argument contract. Tensor planes
    keep their dtypes (int16 recon in, int16 out); numpy inputs run on
    the CPU."""
    y, u, v = (p if isinstance(p, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(p)) for p in (y, u, v))
    return deblock_frame(y, u, v, qp_map, intra=intra, nz4=nz4, mv=mv,
                         mb_row0=mb_row0, total_mb_rows=total_mb_rows,
                         ops=_ops_for(y.device))


def nz4_from_luma_plane(z_plane, mbh: int, mbw: int):
    """(H, W) quantized luma coeff plane → (4·mbh, 4·mbw) any-nonzero
    per 4x4 block (the P-frame bS=2 input, computed on the device from
    the same levels the packer ships)."""
    H, W = 16 * mbh, 16 * mbw
    b = z_plane[:H, :W].reshape(4 * mbh, 4, 4 * mbw, 4)
    return (b != 0).any(dim=3).any(dim=1)
