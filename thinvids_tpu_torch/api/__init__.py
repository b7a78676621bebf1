"""HTTP API: the JSON control surface over the coordinator.

Mirrors the reference manager's Flask route surface
on the stdlib http.server —
no framework dependency, same contracts.
"""

from .server import ApiServer

__all__ = ["ApiServer"]
