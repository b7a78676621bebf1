"""Device selection for the port's entry points.

Every entry point takes a ``device`` argument that defaults to
``"cuda"``. The CPU runs only when the caller asks for it (the parity
tests do); a missing card raises instead of falling back quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` (str or torch.device) → torch.device; raises RuntimeError
    when a CUDA device is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
