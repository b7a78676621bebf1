"""Device selection for the port's entry points, and the device mesh.

Every entry point takes a ``device`` argument that defaults to
``"cuda"``. The CPU runs only when the caller asks for it (the parity
tests do); a missing card raises instead of falling back quietly.

A :class:`DeviceMesh` is the port's counterpart of the reference's
``("gop",)`` mesh: an ordered tuple of devices that the GOP waves, the
split-frame band runs, rate control and the ladder spread over. Entries
may repeat — ``DeviceMesh(("cpu",) * D)`` is a D-wide mesh on the CPU,
and two ``cuda:0`` entries run the mesh path on a one-card machine.
Every entry works on its card's default stream
(:meth:`DeviceMesh.stream`), so two entries on one card enqueue in host
order on one stream: nothing one entry makes (an upload, a cached
table, a band edge) can be read by the other before it is written, and
the caching allocator never hands one entry a block the other still
reads. Two entries on one card therefore do not overlap on the card;
they exercise the mesh path, they do not measure it.
"""

from __future__ import annotations

import contextlib

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


def _entry_device(entry) -> torch.device:
    """One mesh entry → torch.device. A CUDA entry must name its card
    (``cuda:N``) and the card must exist: a mesh never lands on another
    card than the one it names."""
    dev = torch.device(entry)
    if dev.type == "cuda":
        if dev.index is None:
            raise ValueError(f"mesh entry {str(entry)!r}: name the card "
                             "(cuda:N)")
        resolve_device(dev)
        count = torch.cuda.device_count()
        if dev.index >= count:
            raise RuntimeError(f"mesh entry {str(entry)!r}: this host has "
                               f"{count} CUDA card(s)")
    elif dev.type != "cpu":
        raise ValueError(f"mesh entry {str(entry)!r}: want cpu or cuda:N")
    return dev


class DeviceMesh:
    """An ordered, non-empty tuple of devices (``.devices``, ``.size``)."""

    def __init__(self, devices) -> None:
        devs = tuple(_entry_device(d) for d in devices)
        if not devs:
            raise ValueError("a device mesh needs at least one entry")
        self.devices: tuple[torch.device, ...] = devs

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct_cards(self) -> int:
        """How many different devices the entries name."""
        return len(set(self.devices))

    def __len__(self) -> int:
        return self.size

    def __eq__(self, other) -> bool:
        return isinstance(other, DeviceMesh) and other.devices == self.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"DeviceMesh({[str(d) for d in self.devices]})"

    def shrink(self, drop: int) -> "DeviceMesh":
        """This mesh without its last `drop` entries."""
        return DeviceMesh(self.devices[:self.size - int(drop)])

    def stream(self, i: int):
        """Entry `i`'s CUDA stream, its card's default stream (None for a
        CPU entry)."""
        dev = self.devices[i]
        if dev.type != "cuda":
            return None
        return torch.cuda.default_stream(dev)

    @contextlib.contextmanager
    def on(self, i: int):
        """Make entry `i` the calling thread's current device and its
        stream the current stream (a no-op for a CPU entry). A new host
        thread's current card is cuda:0, so every per-entry call runs
        under this."""
        s = self.stream(i)
        if s is None:
            yield
            return
        with torch.cuda.device(self.devices[i]), torch.cuda.stream(s):
            yield


def as_mesh(mesh=None, device="cuda") -> DeviceMesh:
    """`mesh` (a DeviceMesh, or a sequence of devices) → DeviceMesh; None
    gives the one-entry mesh on `device` (a bare ``cuda`` names the
    current card). Anything else raises: a mesh is never dropped
    quietly."""
    if mesh is None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return DeviceMesh((dev,))
    if isinstance(mesh, DeviceMesh):
        return mesh
    if isinstance(mesh, (list, tuple)):
        return DeviceMesh(mesh)
    raise TypeError(f"mesh: want a DeviceMesh (or a sequence of devices), "
                    f"got {type(mesh).__name__}")


def default_mesh(devices=None) -> DeviceMesh:
    """Every visible card in index order (the reference's default mesh:
    every device), or the given `devices`."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return DeviceMesh(devices)


def parse_devices(spec: str, device="cuda") -> DeviceMesh:
    """The CLI's ``--devices``: ``all`` (every visible card), a comma
    list (``cuda:0,cuda:1``, ``cpu,cpu``), or empty for the one
    `device`."""
    spec = (spec or "").strip()
    if not spec:
        return as_mesh(None, device)
    if spec == "all":
        return default_mesh()
    return DeviceMesh([s.strip() for s in spec.split(",") if s.strip()])
