"""GOP planning and wave dispatch over a device mesh.

Imports are lazy: the process-based pack sidecars (packproc.py) live in
this package but run in spawned children that must import it WITHOUT
dragging dispatch's torch dependency in (initializing a CUDA context in
every pack worker would be wrong on a card host).
"""

__all__ = ["plan_segments", "GopShardEncoder", "encode_clip_sharded"]


def __getattr__(name):
    if name == "plan_segments":
        from .planner import plan_segments

        return plan_segments
    if name in ("GopShardEncoder", "encode_clip_sharded"):
        from . import dispatch

        return getattr(dispatch, name)
    raise AttributeError(name)
